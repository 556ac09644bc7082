"""Weights carried across from the JAX package.

``params_from_reference`` turns the reference's parameter pytree,
given as numpy arrays (``jax.tree.map(np.asarray, params)``), into the
port's ``LM``: the leading scan axis of the stacked units is unstacked
into ``units.<i>``, the tail and a tied or untied head are carried as
they are.  A bf16 leaf arrives as an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses; it goes through float32, which holds every
bf16 value exactly.

``params_tree`` gives the port's parameters in the reference's tree
(units stacked on a leading axis, leaves keyed by the reference's paths)
and ``load_params_tree`` copies such a tree back, unstacking the units;
``train_state_from_reference`` and ``train_state_to_numpy`` carry a
whole train state (``train.train_step``'s ``params``, ``opt`` and
``step``: AdamW's ``master``/``m``/``v`` or Adafactor's ``vr``/``vc``/
``v``, which the port keeps in the reference's tree already) across in
either direction.

``cache_from_reference`` and ``cache_to_numpy`` carry a serving cache
(``serve.engine``'s tree of ``units`` / ``tail`` / ``pos``) across the
same way, leaf by leaf with the same tree: every value exactly, the
positions as the port's int64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.train.tree import leaves, tree_map, unflatten

__all__ = ["cache_from_reference", "cache_to_numpy", "load_leaves",
           "load_params_tree", "param_groups", "params_from_reference",
           "params_tree", "reference_leaves", "train_state_from_reference",
           "train_state_to_numpy"]


def reference_leaves(np_params: dict, cfg: ModelConfig) -> dict:
    """The reference's leaves by the port's parameter name, with the
    units' scan axis unstacked: ``{"units.0.b0.attn.wq.w": array, ...}``."""
    out = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}.{i}", child)
        else:
            out[prefix] = np.asarray(node)

    for key, node in np_params.items():
        if key == "units":
            for i in range(cfg.units):
                walk(f"units.{i}", _index(node, i))
        else:
            walk(key, node)
    return out


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def params_from_reference(np_params: dict, cfg: ModelConfig,
                          device="cuda", *, ep: int = 1) -> LM:
    """The port's ``LM`` holding the reference's parameters; a MoE
    block's ``norm``, ``router.w``, ``w_gate``, ``w_up``, ``w_down`` and
    ``shared``, and a recurrent block's ``rec`` subtree (``lambda``,
    ``conv_w``, ``conv_b``, ``r_gates``, ``head_norm``, ...) keep their
    paths.  ``ep`` is the expert-parallel degree the
    reference padded the experts for (its context's tp size).

    Raises ``ValueError`` if the two trees name different parameters or
    disagree on a shape."""
    return load_leaves(LM(cfg, device=device, ep=ep),
                       reference_leaves(np_params, cfg))


def load_leaves(module, leaves: dict):
    """Copy ``leaves`` (parameter name -> numpy array) into ``module``'s
    parameters; returns ``module``.  Raises ``ValueError`` if the names or
    a shape differ."""
    params = dict(module.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(
            f"parameter trees differ: only in the reference "
            f"{sorted(set(leaves) - set(params))}, only in the port "
            f"{sorted(set(params) - set(leaves))}"
        )
    for name, param in params.items():
        leaf = leaves[name]
        if tuple(leaf.shape) != tuple(param.shape):
            raise ValueError(
                f"{name}: reference shape {leaf.shape} != port shape "
                f"{tuple(param.shape)}"
            )
        src = torch.from_numpy(np.array(leaf, dtype=np.float32))
        param.data.copy_(src)  # exact: every leaf is fp32 or bf16
    return module


def cache_from_reference(np_cache, device="cuda"):
    """The port's serving cache holding the reference's (given as numpy
    arrays, ``jax.tree.map(np.asarray, cache)``): the same nested dicts
    and lists, each leaf a tensor of the same shape on ``device`` — bf16
    exactly (through float32), int8 as int8, and the int32 positions as
    the port's int64."""
    if isinstance(np_cache, dict):
        return {k: cache_from_reference(v, device) for k, v in
                np_cache.items()}
    if isinstance(np_cache, (list, tuple)):
        return [cache_from_reference(v, device) for v in np_cache]
    a = np.asarray(np_cache)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                           torch.bfloat16)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def cache_to_numpy(cache):
    """A serving cache as numpy arrays with the same tree (bf16 as
    float32, which holds it exactly)."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return [cache_to_numpy(v) for v in cache]
    t = cache.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def param_groups(model: LM) -> dict[str, list]:
    """The reference's leaf path -> the port's parameters that form it:
    the U parameters of a unit leaf in unit order (``units.<i>.b0.attn.
    wq.w`` for ``units/b0/attn/wq/w``), one parameter elsewhere."""
    groups: dict[str, list] = {}
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "units":
            parts = parts[:1] + parts[2:]  # drop the unit index
        groups.setdefault("/".join(parts), []).append(param)
    return groups


def _is_unit(path: str) -> bool:
    return path.startswith("units/")


def params_tree(model: LM, grads: bool = False) -> dict:
    """The parameters (or, with ``grads``, their gradients in fp32, zero
    where a parameter has none) in the reference's tree: each unit leaf
    stacked on a leading axis of the units (a new tensor), every other
    leaf the parameter itself, detached."""

    def leaf(p):
        if not grads:
            return p.detach()
        return (p.grad.float() if p.grad is not None
                else torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device))

    flat = {}
    for path, params in param_groups(model).items():
        if _is_unit(path):
            flat[path] = torch.stack([leaf(p) for p in params])
        else:
            flat[path] = leaf(params[0])
    return unflatten(flat)


@torch.no_grad()
def load_params_tree(model: LM, tree) -> LM:
    """Copy a tree of the reference's layout (tensors or numpy arrays,
    units stacked) into ``model``'s parameters; returns ``model``.
    Raises ``ValueError`` if the paths or a shape differ."""
    flat = dict(leaves(tree))
    groups = param_groups(model)
    if set(flat) != set(groups):
        raise ValueError(
            f"parameter trees differ: only in the tree "
            f"{sorted(set(flat) - set(groups))}, only in the model "
            f"{sorted(set(groups) - set(flat))}"
        )
    for path, params in groups.items():
        src = flat[path]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
        parts = list(src) if _is_unit(path) else [src]
        if len(parts) != len(params) or any(
                tuple(a.shape) != tuple(p.shape)
                for a, p in zip(parts, params)):
            raise ValueError(
                f"{path}: tree shape {tuple(src.shape)} does not fit "
                f"{len(params)} parameter(s) of shape "
                f"{tuple(params[0].shape)}")
        for a, p in zip(parts, params):
            p.copy_(a)
    return model


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                           torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def train_state_from_reference(np_state: dict, cfg: ModelConfig,
                               device="cuda", *, ep: int = 1,
                               ctx=None) -> dict:
    """The port's train state holding the reference's (given as numpy
    arrays, ``jax.tree.map(np.asarray, state)``): ``params`` an ``LM``
    whose parameters require grad, ``opt`` the same tree of tensors (every
    value exactly), ``step`` an int32 scalar tensor.  With the ``ctx`` of
    a grid of more than one rank, this rank's blocks of it
    (``train.train_step.shard_model`` and ``load_state_tree``)."""
    model = params_from_reference(np_state["params"], cfg, device, ep=ep)
    state = {
        "params": model.requires_grad_(True),
        "opt": tree_map(lambda a: _tensor(a, device), np_state["opt"]),
        "step": _tensor(np.asarray(np_state["step"], np.int32), device),
    }
    if ctx is None:
        return state
    from repro_torch.train import train_step as ts

    whole = {"params": params_tree(model), "opt": state["opt"],
             "step": state["step"]}
    ts.shard_model(model, ctx)
    return ts.load_state_tree(state, whole, ctx)


def train_state_to_numpy(state: dict, ctx=None) -> dict:
    """A train state in the reference's tree as numpy arrays (bf16 as
    float32, which holds it exactly); with the ``ctx`` of a sharded state,
    whole (each rank of its grid calls it)."""
    from repro_torch.train.train_step import state_tree

    return cache_to_numpy(state_tree(state, ctx))
