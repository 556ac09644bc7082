"""Train-step construction: grad accumulation, optimizer apply, specs.

The port of ``repro.train.train_step``.  A train state is ``{"params":
LM (parameters requiring grad), "opt": the optimizer's state, "step":
int32 scalar tensor}``; the optimizer's state is a tree of the
reference's layout (units stacked on a leading axis, ``train.tree``
paths), and ``state_tree`` gives the whole state in that layout, which
checkpoints keep.  ``build_train_step`` returns a step that accumulates
gradients in fp32 over ``microbatches`` slices of the global batch
(each microbatch's ``.grad`` taken fresh and added into an fp32
accumulator of zeros, so the result is the reference's ``lax.scan``
sum), then applies the optimizer once and updates the state in place.

Sharding is spec tuples only (``state_shardings``, ``batch_shardings``:
the reference's NamedShardings' specs, its mirror rule included): every
rank holds whole tensors and runs the same step on the whole batch
(ROADMAP A8b), so ``ctx.zero1`` changes no number.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import param_shardings
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (
    load_params_tree,
    param_groups,
    params_tree,
)
from repro_torch.models.model import LM, init_model, loss_fn
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.tree import at, leaves, tree_map, unflatten

__all__ = ["abstract_train_state", "batch_shardings", "build_train_step",
           "load_state_tree", "make_train_state", "microbatch_of",
           "state_shardings", "state_tree", "train_state", "zero_grads"]


def train_state(model: LM, opt: Optimizer) -> dict:
    """The train state of ``model``: its parameters made to require grad,
    the optimizer's state initialised from them, step 0."""
    model.requires_grad_(True)
    device = next(model.parameters()).device
    return {"params": model, "opt": opt.init(params_tree(model)),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_train_state(cfg: ModelConfig, ctx: ParallelCtx, opt: Optimizer, *,
                     generator: torch.Generator, device="cuda") -> dict:
    """A train state with parameters drawn from ``generator`` (on
    ``device``), experts padded for ``ctx``'s tp size."""
    model = init_model(cfg, generator=generator, device=device,
                       ep=ctx.tp_size)
    return train_state(model, opt)


def abstract_train_state(cfg: ModelConfig, ctx: ParallelCtx,
                         opt: Optimizer) -> dict:
    """The train state on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return train_state(LM(cfg, device="meta", ep=ctx.tp_size), opt)


def state_tree(state: dict) -> dict:
    """The whole state in the reference's tree (a checkpoint's layout):
    the parameters stacked over the units (new tensors), the optimizer's
    state and the step as they are."""
    return {"params": params_tree(state["params"]), "opt": state["opt"],
            "step": state["step"]}


def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a tree of ``state_tree``'s layout (a restored checkpoint)
    into ``state``; returns ``state``."""
    load_params_tree(state["params"], tree["params"])
    state["opt"] = tree["opt"]
    state["step"] = tree["step"]
    return state


def _stacked_shapes(model: LM) -> dict:
    """Reference path -> the parameter's shape in the reference's tree
    (a unit's leaves stacked on a leading axis)."""
    out = {}
    for path, params in param_groups(model).items():
        shape = tuple(params[0].shape)
        out[path] = (len(params), *shape) if path.startswith("units/") else shape
    return out


def state_shardings(state: dict, ctx: ParallelCtx) -> dict:
    """Spec tuples for the whole train state, in ``state_tree``'s layout.

    With ``ctx.zero1`` params are replicated over the FSDP axis while the
    optimizer mirrors stay FSDP-sharded (the reference's ZeRO-3 <->
    ZeRO-1 trade-off).  An optimizer slot takes the spec of the first
    parameter (in the reference's leaf order) whose shape it has; a
    factored slot (Adafactor's ``vr``/``vc``) the spec of the first whose
    shape less its last or second-to-last dim it has, less that dim's
    entry; any other leaf is replicated."""
    if not ctx.has_grid:
        raise ValueError("state_shardings needs a grid; got grid=None")
    tp = not ctx.pure_dp
    shapes = _stacked_shapes(state["params"])
    p_sh = param_shardings(shapes, ctx.grid, fsdp=not ctx.zero1, tp=tp)
    opt_ref = (param_shardings(shapes, ctx.grid, fsdp=True, tp=tp)
               if ctx.zero1 else p_sh)
    order = [(shapes[path], opt_ref[path])
             for _, path in leaves(unflatten({k: k for k in shapes}))]

    def assign(leaf):
        shape = tuple(leaf.shape)
        for p_shape, spec in order:
            if shape == p_shape:
                return spec
            if shape == p_shape[:-1]:
                return spec[:-1]
            if shape == p_shape[:-2] + p_shape[-1:]:
                return spec[:-2] + spec[-1:]
        return ()

    return {
        "params": unflatten(p_sh),
        "opt": tree_map(assign, state["opt"]),
        "step": (),
    }


def batch_shardings(batch: dict, ctx: ParallelCtx) -> dict:
    """Each batch leaf sharded over the data-parallel axis on its first
    dimension."""
    return {k: (ctx.dp, *([None] * (len(np.shape(x)) - 1)))
            for k, x in batch.items()}


def _to_device(batch: dict, cfg: ModelConfig, device) -> dict:
    """A numpy batch as tensors on ``device``: integer leaves as int64,
    embeddings in the model's dtype."""
    out = {}
    for k, x in batch.items():
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        elif k == "embeds":
            t = t.to(L.torch_dtype(cfg.dtype))
        out[k] = t.to(device)
    return out


def _accumulate(grads: dict, model: LM) -> None:
    """Add each parameter's ``.grad`` into the fp32 tree ``grads`` (in
    place; the bf16 gradient widens exactly in the add)."""
    for path, params in param_groups(model).items():
        acc = at(grads, path)
        for u, p in enumerate(params):
            if p.grad is not None:
                (acc[u] if path.startswith("units/") else acc).add_(p.grad)


def zero_grads(model: LM) -> dict:
    """The fp32 gradient accumulator of ``model``: zeros in the reference's
    tree (units stacked)."""
    device = next(model.parameters()).device
    return unflatten({path: torch.zeros(shape, dtype=torch.float32,
                                        device=device)
                      for path, shape in _stacked_shapes(model).items()})


def microbatch_of(batch: dict, i: int, microbatches: int) -> dict:
    """The ``i``-th of ``microbatches`` equal slices of ``batch`` along its
    batch axis (views)."""
    return {k: x[i * (x.shape[0] // microbatches):
                 (i + 1) * (x.shape[0] // microbatches)]
            for k, x in batch.items()}


def build_train_step(
    cfg: ModelConfig,
    ctx: ParallelCtx,
    opt: Optimizer,
    *,
    microbatches: int = 1,
    remat: bool = True,
):
    """``train_step(state, batch) -> (state, metrics)``: one optimizer
    step on ``batch`` (numpy arrays or tensors, sliced into
    ``microbatches`` along the batch); ``state`` is updated in place.
    The metrics are the last microbatch's (``ce``, ``z_loss``, ``aux``,
    ``loss``, fp32 scalar tensors), as the reference's scan carries.

    As the reference, one microbatch takes its gradients in fp32; several
    add theirs into an fp32 accumulator of zeros, one microbatch at a
    time, each the same work.  The step's three parts are its attributes,
    so a count can run one microbatch of several and weight it
    (``launch.dryrun``): ``begin(state, batch) -> (batch on the device,
    accumulator or None)``, ``accumulate(model, mb, grads) -> metrics``
    (one microbatch of several) and ``finish(state, grads)`` (the mean,
    the optimizer's update, the step count)."""

    def grad_fn(model, mb):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, mb, cfg, ctx, remat=remat)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def begin(state, batch):
        model = state["params"]
        batch = _to_device(batch, cfg, state["step"].device)
        return batch, zero_grads(model) if microbatches > 1 else None

    def accumulate(model, mb, grads):
        metrics = grad_fn(model, mb)
        _accumulate(grads, model)
        return metrics

    def finish(state, grads):
        model = state["params"]
        if microbatches > 1:
            for _, acc in leaves(grads):
                acc.div_(microbatches)
        model.zero_grad(set_to_none=True)
        new_params, state["opt"] = opt.update(
            grads, state["opt"], params_tree(model), state["step"])
        grads.clear()  # the accumulator goes before the new parameters land
        load_params_tree(model, new_params)
        state["step"] = state["step"] + 1

    def train_step(state, batch):
        model = state["params"]
        batch, grads = begin(state, batch)
        if grads is None:
            metrics = grad_fn(model, batch)
            grads = params_tree(model, grads=True)
        else:
            for i in range(microbatches):
                metrics = accumulate(model, microbatch_of(batch, i,
                                                          microbatches), grads)
        finish(state, grads)
        return state, metrics

    train_step.begin = begin
    train_step.accumulate = accumulate
    train_step.finish = finish
    return train_step
