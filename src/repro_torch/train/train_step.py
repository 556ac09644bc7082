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

On a grid of more than one rank the state is sharded
(``make_train_state`` / ``shard_model``): each parameter is the rank's
block under ``param_shardings`` (``fsdp=not ctx.zero1``, ``tp=not
ctx.pure_dp``) and each optimizer leaf its block under
``state_shardings``' spec (the reference's NamedShardings' specs, its
mirror rule included: with ``zero1`` the optimizer state stays sharded
over the FSDP axis).  Every rank is given the global batch and runs its
rows (``models.model.loss_fn``); after each backward the gradient of a
parameter replicated over a dp axis is summed there (``sync_grads``);
the optimizer reads where each leaf lies (``optimizer.Shards``).  The
number of microbatches is capped at ``global_batch // dp``, as the
reference's dry run caps it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import cost

from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import (
    block_of,
    gather_block,
    param_shardings,
    shard_params,
    spec_of,
)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (
    load_params_tree,
    param_groups,
    params_tree,
)
from repro_torch.models.model import LM, init_model, loss_fn
from repro_torch.train.optimizer import Optimizer, Shards
from repro_torch.train.tree import (at, leaves, tree_map,
                                   tree_map_with_path, unflatten)

__all__ = ["abstract_train_state", "batch_shardings", "build_train_step",
           "load_state_tree", "make_train_state", "microbatch_of",
           "shard_model", "shards", "state_shardings", "state_target",
           "state_tree", "sync_grads", "train_state", "zero_grads"]


def _many(ctx: ParallelCtx) -> bool:
    return ctx.has_grid and ctx.grid.axis_size(ctx.grid.axis_names) > 1


def shard_model(model: LM, ctx: ParallelCtx) -> LM:
    """``model``'s parameters cut to this rank's blocks for ``ctx``
    (``fsdp=not ctx.zero1``, ``tp=not ctx.pure_dp``); on a grid of one
    rank, ``model`` as it is."""
    if not _many(ctx):
        return model
    return shard_params(model, ctx.grid, fsdp=not ctx.zero1,
                        tp=not ctx.pure_dp)


def train_state(model: LM, opt: Optimizer,
                ctx: ParallelCtx | None = None) -> dict:
    """The train state of ``model``: its parameters made to require grad,
    the optimizer's state initialised from them (on a grid of more than
    one rank, where ``model`` holds its blocks (``shard_model``), each
    leaf this rank's block under ``state_shardings``), step 0."""
    model.requires_grad_(True)
    device = next(model.parameters()).device
    opt_state = opt.init(params_tree(model))
    if ctx is not None and _many(ctx):
        if any(spec_of(p) is None for p in model.parameters()):
            raise ValueError("on a grid of more than one rank the model "
                             "holds its blocks: shard_model(model, ctx)")
        sh = shards(model, ctx, opt)
        opt_state = tree_map_with_path(
            lambda path, x: sh.move(x, _param_layout(path, sh),
                                    at(sh.state, path)), opt_state)
    return {"params": model, "opt": opt_state,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _slot(opt_path: str, params) -> tuple:
    """``(parameter path, factored slot or None)`` of an optimizer leaf:
    a slot of its parameter's shape, or a factored one (``vr``, ``vc``,
    Adafactor's ``v``)."""
    path = opt_path.split("/", 1)[1]
    return (path, None) if path in params else tuple(path.rsplit("/", 1))


def _factored(x: tuple, kind) -> tuple:
    """A parameter's shape or spec ``x`` as its slot ``kind`` has it."""
    return {None: x, "vr": x[:-1], "vc": x[:-2] + x[-1:], "v": x}[kind]


def _param_layout(opt_path: str, sh: Shards) -> tuple:
    """The spec of an optimizer leaf initialised from the parameters'
    blocks: its parameter's, less the dim a factored slot reduces."""
    path, kind = _slot(opt_path, sh.params)
    return _factored(sh.params[path], kind)


def make_train_state(cfg: ModelConfig, ctx: ParallelCtx, opt: Optimizer, *,
                     generator: torch.Generator, device="cuda") -> dict:
    """A train state with parameters drawn from ``generator`` (on
    ``device``), experts padded for ``ctx``'s tp size; on a grid of more
    than one rank, sharded (``shard_model``)."""
    model = init_model(cfg, generator=generator, device=device,
                       ep=ctx.tp_size)
    return train_state(shard_model(model, ctx), opt, ctx)


def abstract_train_state(cfg: ModelConfig, ctx: ParallelCtx,
                         opt: Optimizer) -> dict:
    """The train state on the ``meta`` device: shapes and dtypes, no
    allocation (rank ``ctx.grid.coords``' blocks on a grid of more than
    one rank)."""
    model = shard_model(LM(cfg, device="meta", ep=ctx.tp_size), ctx)
    return train_state(model, opt, ctx)


def state_tree(state: dict, ctx: ParallelCtx | None = None) -> dict:
    """The state in the reference's tree (a checkpoint's layout): the
    parameters stacked over the units (new tensors), the optimizer's
    state and the step as they are.  With the ``ctx`` of a grid of more
    than one rank, every leaf whole (each rank of the grid calls it)."""
    tree = {"params": params_tree(state["params"]), "opt": state["opt"],
            "step": state["step"]}
    if ctx is None or not _many(ctx):
        return tree
    specs = state_shardings(state, ctx)
    return tree_map(lambda x, spec: gather_block(x, spec, ctx.grid) if spec
                    else x, tree, specs)


def state_target(state: dict) -> dict:
    """``state_tree``'s leaves as ``meta`` tensors of their whole shapes
    and dtypes: a restore's target."""
    def meta(x, shape):
        return torch.empty(shape, dtype=x.dtype, device="meta")

    model = state["params"]
    shapes = _stacked_shapes(model, whole=True)
    params = tree_map_with_path(lambda path, x: meta(x, shapes[path]),
                                params_tree(model))
    return {"params": params, "opt": _opt_meta(state["opt"], shapes),
            "step": meta(state["step"], ())}


def _opt_meta(opt_state, shapes):
    """The optimizer state's leaves as ``meta`` tensors of their whole
    shapes (from their parameters')."""
    def meta(path, x):
        param, kind = _slot(path, shapes)
        return torch.empty(_factored(shapes[param], kind), dtype=x.dtype,
                           device="meta")

    return tree_map_with_path(meta, opt_state)


def load_state_tree(state: dict, tree: dict,
                    ctx: ParallelCtx | None = None) -> dict:
    """Copy a tree of ``state_tree``'s layout (a restored checkpoint)
    into ``state``; returns ``state``.  With the ``ctx`` of a grid of
    more than one rank, ``tree``'s leaves are whole and each rank keeps its
    blocks."""
    if ctx is not None and _many(ctx):
        specs = state_shardings(state, ctx)
        tree = tree_map(lambda x, spec: block_of(x, spec, ctx.grid)
                        if spec else x, tree, specs)
    load_params_tree(state["params"], tree["params"])
    state["opt"] = tree["opt"]
    state["step"] = tree["step"]
    return state


def _stacked_shapes(model: LM, whole: bool = False) -> dict:
    """Reference path -> the parameter's shape in the reference's tree (a
    unit's leaves stacked on a leading axis): the shape of this rank's
    block, or with ``whole`` the whole one."""
    out = {}
    for path, params in param_groups(model).items():
        p = params[0]
        shape = tuple(getattr(p, "full_shape", p.shape) if whole
                      else p.shape)
        out[path] = (len(params), *shape) if path.startswith("units/") else shape
    return out


def shards(model: LM, ctx: ParallelCtx, opt: Optimizer) -> Shards:
    """Where a sharded train state's leaves lie (``state_shardings``),
    derived from shapes on ``meta`` outside any count."""
    with cost.paused():
        shapes = _stacked_shapes(model, whole=True)
        params = {path: torch.empty(shape, device="meta")
                  for path, shape in shapes.items()}
        specs = state_shardings({"params": model,
                                 "opt": opt.init(unflatten(params))}, ctx)
    return Shards(ctx.grid, dict(leaves(specs["params"])), specs["opt"])


def state_shardings(state: dict, ctx: ParallelCtx) -> dict:
    """Spec tuples for the whole train state, in ``state_tree``'s layout.

    With ``ctx.zero1`` params are replicated over the FSDP axis while the
    optimizer mirrors stay FSDP-sharded (the reference's ZeRO-3 <->
    ZeRO-1 trade-off).  An optimizer slot takes the spec of the first
    parameter (in the reference's leaf order) whose shape it has; a
    factored slot (Adafactor's ``vr``/``vc``) the spec of the first whose
    shape less its last or second-to-last dim it has, less that dim's
    entry; any other leaf is replicated.  Shapes are the whole ones, of a
    sharded state too."""
    if not ctx.has_grid:
        raise ValueError("state_shardings needs a grid; got grid=None")
    tp = not ctx.pure_dp
    shapes = _stacked_shapes(state["params"], whole=True)
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
        "opt": tree_map(assign, _opt_meta(state["opt"], shapes)),
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


def sync_grads(model: LM, ctx: ParallelCtx) -> None:
    """Sum, in place, the gradient of each parameter over the dp axes its
    block is replicated on: each rank's holds the part of its own rows (a
    block sharded over the FSDP axis has its sum from
    ``Grid.fsdp_gather``'s backward already)."""
    if ctx.dp_size == 1:
        return
    for p in model.parameters():
        spec = spec_of(p) or ()
        axes = tuple(a for a in ctx.dp_axes if ctx.grid.shape[a] > 1 and
                     all(a != e and a not in (e if isinstance(e, tuple)
                                              else ()) for e in spec))
        if axes and p.grad is not None:
            p.grad = ctx.grid.all_reduce(p.grad, axes if len(axes) > 1
                                         else axes[0])


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
    the optimizer's update, the step count).  On a grid each rank is
    given the global batch; ``microbatches`` is capped at its rows // dp.
    Where the state's leaves lie (``shards``) is derived once, on the
    first step of a grid of more than one rank."""
    layout = {}

    def grad_fn(model, mb):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, mb, cfg, ctx, remat=remat)
        loss.backward()
        sync_grads(model, ctx)
        return {k: v.detach() for k, v in metrics.items()}

    def begin(state, batch):
        model = state["params"]
        batch = _to_device(batch, cfg, state["step"].device)
        return batch, zero_grads(model) if microbatches > 1 else None

    def accumulate(model, mb, grads):
        metrics = grad_fn(model, mb)
        _accumulate(grads, model)
        return metrics

    def finish(state, grads, n=microbatches):
        model = state["params"]
        if n > 1:
            for _, acc in leaves(grads):
                acc.div_(n)
        model.zero_grad(set_to_none=True)
        kw = {}
        if _many(ctx):
            if layout.get("model") is not model:
                layout.update(model=model, shards=shards(model, ctx, opt))
            kw["shards"] = layout["shards"]
        new_params, state["opt"] = opt.update(
            grads, state["opt"], params_tree(model), state["step"], **kw)
        grads.clear()  # the accumulator goes before the new parameters land
        load_params_tree(model, new_params)
        state["step"] = state["step"] + 1

    def train_step(state, batch):
        model = state["params"]
        batch, grads = begin(state, batch)
        rows = next(iter(batch.values())).shape[0]
        n = max(1, min(microbatches, rows // ctx.dp_size))
        if n == 1:
            grads = None
        if grads is None:
            metrics = grad_fn(model, batch)
            grads = params_tree(model, grads=True)
        else:
            for i in range(n):
                metrics = accumulate(model, microbatch_of(batch, i, n), grads)
        finish(state, grads, n)
        return state, metrics

    train_step.begin = begin
    train_step.accumulate = accumulate
    train_step.finish = finish
    return train_step
