"""Optimizers: AdamW (fp32 master + moments) and Adafactor (factored).

The port of ``repro.train.optimizer``: pure functions over trees of
tensors (``train.tree``), no ``torch.optim``.  AdamW keeps an fp32
master copy so bf16 params don't lose small updates.  Adafactor stores
row/column-factored second moments and no master/first moment.  Both
include global-norm clipping and a linear-warmup + cosine schedule, and
compute the schedule and bias corrections as fp32 tensors from the step
tensor, as the reference does (no host sync).

The trees are the reference's: the train step hands the optimizer the
units' parameters and gradients stacked on a leading unit axis
(``units/b0/attn/wq/w`` of shape ``(U, d_in, d_out)``), so the rules
that read a leaf's rank or reduce over a whole leaf see the reference's
leaf: a unit's norm scale ``(U, d)`` is weight-decayed by AdamW and
factored by Adafactor (its ``vc`` shared by the units), and Adafactor's
RMS update clip is taken over the whole stacked leaf.

``update(grads, opt_state, params, step) -> (new_params, opt_state)``
updates ``opt_state`` in place (each slot is replaced leaf by leaf, so
the old and new state never coexist in memory) and returns new params;
each leaf of ``grads`` is dropped from its tree (set to ``None``) once
it has been read, so the gradients already applied do not stay beside
the new state (with AdamW on mixtral-8x7b's stacked expert leaves, 3.5
GiB each in fp32, the difference decides whether a step fits the card).

On a sharded train state (``train.train_step``) every leaf is this
rank's block, and ``update(..., shards=Shards(...))`` says where each
lies: the global norm sums each leaf's squares over the axes the leaf
is sharded on (and not over those it is replicated on), AdamW updates
its moments and master in their slots' layout (ZeRO-1: a block over
the FSDP axis of a parameter every rank holds whole over it, the new
parameter gathered back), and Adafactor's row and column means and its
RMS clip reduce over the sharded dims.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.train.tree import at, leaves, tree_map

__all__ = ["OptimizerConfig", "Optimizer", "Shards", "make_optimizer"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # "adamw" | "adafactor"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    af_eps: float = 1e-30


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, opt_state)


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    step = _step_f32(step)
    warm = (step + 1.0) / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.minimum(warm, cos)


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where the leaves of a sharded train state lie on ``grid``:
    ``params`` maps a parameter's path to the spec of its block (and of
    its gradient's), ``state`` is the optimizer state's tree of specs."""

    grid: Any
    params: dict
    state: Any

    def live(self, spec) -> tuple:
        """The axes of ``spec`` with more than one rank."""
        return tuple(a for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))
                     if self.grid.axis_size(a) > 1)

    def move(self, x: torch.Tensor, src, dst) -> torch.Tensor:
        from repro_torch.dist.partitioning import reshard

        return reshard(x, src, dst, self.grid)

    def mean(self, x: torch.Tensor, dim: int, spec) -> torch.Tensor:
        """The mean of the whole tensor along ``dim``, of which ``x`` is
        the block under ``spec``."""
        axes = self.live(spec[dim:dim + 1] if dim >= 0 else
                         spec[len(spec) + dim:len(spec) + dim + 1])
        if not axes:
            return x.mean(dim=dim)
        n = x.shape[dim] * self.grid.axis_size(axes)
        return self.grid.all_reduce(x.sum(dim=dim), axes) / n

    def mean_all(self, x: torch.Tensor, spec) -> torch.Tensor:
        axes = self.live(spec)
        if not axes:
            return torch.mean(x)
        n = x.numel() * self.grid.axis_size(axes)
        return self.grid.all_reduce(x.sum(), axes) / n


def _global_norm(tree, shards: Shards | None = None) -> torch.Tensor:
    total = 0
    if shards is None:
        for _, leaf in leaves(tree):
            total = total + torch.sum(torch.square(leaf.float()))
        return torch.sqrt(total)
    by_axes: dict = {}  # one all-reduce per set of axes
    for path, leaf in leaves(tree):
        axes = tuple(sorted(set(shards.live(shards.params[path]))))
        by_axes[axes] = by_axes.get(axes, 0) + torch.sum(
            torch.square(leaf.float()))
    for axes, part in by_axes.items():
        total = total + (shards.grid.all_reduce(part, axes) if axes
                         else part)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def _set(tree, path: str, value) -> None:
    parent, _, key = path.rpartition("/")
    node = at(tree, parent)
    if isinstance(node, list):
        node[int(key)] = value
    else:
        node[key] = value


def _paths(tree) -> list[str]:
    return [path for path, _ in leaves(tree)]


def _take(tree, path: str):
    """The leaf at ``path``, set to ``None`` in ``tree``."""
    leaf = at(tree, path)
    _set(tree, path, None)
    return leaf


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return _make_adamw(cfg)
    if cfg.name == "adafactor":
        return _make_adafactor(cfg)
    raise ValueError(cfg.name)


# ---------------------------------------------------------------- AdamW


def _make_adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
        }

    def update(grads, state, params, step, shards: Shards | None = None):
        scale = _clip_scale(_global_norm(grads, shards), cfg.clip_norm)
        lr = _schedule(cfg, step)
        t = _step_f32(step) + 1.0
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        new_params = tree_map(lambda p: None, params)
        for path in _paths(grads):
            g = _take(grads, path).float() * scale
            if shards is not None:  # into the moments' layout
                spec = shards.params[path]
                slot = at(shards.state["m"], path)
                g = shards.move(g, spec, slot)
            # The reference's expressions, operation by operation (the same
            # roundings), updating only temporaries made here in place and
            # storing each new slot as soon as it is made: a leaf then
            # holds about three temporaries of its size at once, not eight
            # (mixtral-8x7b's stacked expert leaves are 3.5 GiB in fp32).
            m = cfg.b1 * at(state["m"], path)
            m.add_((1 - cfg.b1) * g)
            _set(state["m"], path, m)
            v = (1 - cfg.b2) * g
            v.mul_(g)
            del g
            v = cfg.b2 * at(state["v"], path) + v
            _set(state["v"], path, v)
            delta = m / bc1
            root = v / bc2
            root.sqrt_()
            root.add_(cfg.eps)
            delta.div_(root)
            del m, v, root
            master = at(state["master"], path)
            if master.ndim >= 2:  # decoupled weight decay on matrices only
                delta.add_(cfg.weight_decay * master)
            delta.mul_(lr)
            master = master - delta
            del delta
            _set(state["master"], path, master)
            new = master.to(at(params, path).dtype)
            if shards is not None:
                new = shards.move(new, slot, spec)
            _set(new_params, path, new)
        return new_params, state

    return Optimizer(init=init, update=update)


# ------------------------------------------------------------- Adafactor


def _make_adafactor(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def leaf_state(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                }
            return {"v": torch.zeros(p.shape, **f32)}

        return {"v": tree_map(leaf_state, params)}

    def update(grads, state, params, step, shards: Shards | None = None):
        scale = _clip_scale(_global_norm(grads, shards), cfg.clip_norm)
        lr = _schedule(cfg, step)
        t = _step_f32(step) + 1.0
        beta2 = 1.0 - t ** (-cfg.decay_rate)
        new_params = tree_map(lambda p: None, params)
        for path in _paths(grads):
            g = _take(grads, path).float() * scale
            p = at(params, path)
            v = at(state["v"], path)
            # the update runs in the parameter's layout (``spec``); the
            # factored moments are stored in their own (``slot``)
            spec = (None,) * p.ndim
            slot = {k: spec for k in v}
            if shards is not None:
                spec = shards.params[path]
                slot = at(shards.state["v"], path)
            specs = {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:], "v": spec}

            def mean(x, dim, x_spec):
                if shards is None:
                    return x.mean(dim=dim)
                return shards.mean(x, dim, x_spec)

            def load(k):
                if shards is None:
                    return v[k]
                return shards.move(v[k], slot[k], specs[k])

            g2 = g * g + cfg.af_eps
            if p.ndim >= 2:
                vr = beta2 * load("vr") + (1 - beta2) * mean(g2, -1, spec)
                vc = beta2 * load("vc") + (1 - beta2) * mean(g2, -2, spec)
                # rank-1 reconstruction of the second moment
                denom = vr[..., :, None] * vc[..., None, :]
                denom = denom / torch.clamp(
                    mean(vr, -1, specs["vr"])[..., None, None],
                    min=cfg.af_eps)
                upd = g / torch.sqrt(denom + cfg.af_eps)
                nv = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * load("v") + (1 - beta2) * g2
                upd = g / torch.sqrt(vv + cfg.af_eps)
                nv = {"v": vv}
            del g, g2
            if shards is not None:
                nv = {k: shards.move(x, specs[k], slot[k])
                      for k, x in nv.items()}
            # update clipping by RMS (Adafactor's d=1.0 rule)
            rms = torch.sqrt((torch.mean(upd * upd) if shards is None
                              else shards.mean_all(upd * upd, spec))
                             + 1e-12)
            upd = upd / torch.clamp(rms, min=1.0)
            if p.ndim >= 2:
                upd = upd + cfg.weight_decay * p.float()
            _set(new_params, path, (p.float() - lr * upd).to(p.dtype))
            _set(state["v"], path, nv)
        return new_params, state

    return Optimizer(init=init, update=update)
