"""Path-based FSDP + tensor-parallel sharding specs of the parameters.

The port of ``repro.dist.partitioning``.  Parameters are named by path
(``models.model.LM``'s parameter names equal the reference's pytree
paths, with the stacked units' scan axis unstacked into ``units.<i>``),
so sharding is attached *by path*, never by module type:

* dense kernels ``w`` ``(d_in, d_out)`` — ``("data", "model")``: input
  dim FSDP-sharded, output dim tensor-parallel.
* MoE expert weights (``w_gate`` / ``w_up`` ``(E, d_in, d_out)``,
  ``w_down``) — experts over the TP axis (expert parallelism) and
  ``d_model`` over the FSDP axis.
* embeddings ``(V, D)`` — ``("model", "data")``: vocab over TP, ``D``
  over FSDP.
* biases — output dim over TP; norms / conv / gate vectors replicated.

A spec is a tuple with one entry per dimension (an axis name, a tuple of
names, or ``None``): the reference's ``PartitionSpec`` entries for the
same leaf, less the leading ``None`` of the scan axis.  ``param_specs``
proposes specs from these rules; ``_validate_spec`` makes them safe for
a concrete grid (a dim that does not divide its axis-group size falls
back to replicated); ``param_shardings`` composes both over a mapping of
names to shapes, with ``fsdp=False`` (ZeRO-1 parameters) and
``tp=False`` (pure data parallelism) dropping the respective axes
(``_filter_spec``).  ``train.train_step.state_shardings`` calls it with
the reference's stacked tree.

``shard_params(model, grid, fsdp=..., tp=...)`` stores each parameter as
this rank's block under its validated spec (``block_of``), a
``ShardedParameter`` under the same name carrying that ``spec`` and its
whole ``full_shape``; the model code reads the mark
(``ParallelCtx.weight``) and gathers what its compute needs.  A
parameter without a mark is whole on every rank.
``gather_params`` is the inverse (every rank of the grid calls it), and
``gather_block`` / ``block_of`` do the same for one tensor of a given
spec (optimizer state, checkpoints).
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["ShardedParameter", "block_of", "gather_block", "gather_params",
           "param_specs", "param_shardings", "reshard", "shard_params",
           "spec_of", "_filter_spec", "_leaf_spec", "_validate_spec"]

_FSDP_AXIS = "data"
_TP_AXIS = "model"

#: raw expert weights in models/moe.py (dense layers hold their kernel as
#: ``<layer>.w``, so they never hit these names)
_EXPERT_UP_KEYS = ("w_gate", "w_up")  # (..., E, d_model, d_ff)
_EXPERT_DOWN_KEYS = ("w_down",)  # (..., E, d_ff, d_model)


def _leaf_spec(name: str, shape) -> tuple:
    last = name.replace("/", ".").rsplit(".", 1)[-1]
    nd = len(shape)
    lead = [None] * max(nd - 2, 0)

    if last == "embedding" and nd == 2:
        return (_TP_AXIS, _FSDP_AXIS)
    if last == "w" and nd >= 2:
        return (*lead, _FSDP_AXIS, _TP_AXIS)
    if last == "b" and nd >= 1:
        return (*([None] * (nd - 1)), _TP_AXIS)
    if last in _EXPERT_UP_KEYS and nd >= 3:
        return (*([None] * (nd - 3)), _TP_AXIS, _FSDP_AXIS, None)
    if last in _EXPERT_DOWN_KEYS and nd >= 3:
        return (*([None] * (nd - 3)), _TP_AXIS, None, _FSDP_AXIS)
    # norms, convs, recurrence gates, router (fp32, small): replicated
    return (None,) * nd


def param_specs(model: nn.Module) -> dict[str, tuple]:
    """Parameter name -> spec tuple (one entry per dimension)."""
    return {name: _leaf_spec(name, p.shape)
            for name, p in model.named_parameters()}


def _filter_spec(spec: tuple, *, fsdp: bool, tp: bool) -> tuple:
    """Drop the FSDP and/or TP axis from a spec (ZeRO-1 / pure-DP)."""

    def keep(axis):
        if axis == _FSDP_AXIS and not fsdp:
            return False
        if axis == _TP_AXIS and not tp:
            return False
        return True

    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if keep(a))
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(kept)
    return tuple(out)


def _validate_spec(spec: tuple, shape: tuple[int, ...], grid) -> tuple:
    """Make ``spec`` safe for ``shape`` on ``grid``.

    * a spec longer than the array rank (an over-sharded tree) is a bug in
      the rules — raise;
    * an axis name the grid does not know is a bug in the caller — raise;
    * a dim that does not divide its axis-group size silently falls back
      to replicated for that dim (nonuniform vocab / head counts must
      degrade, not crash).

    ``grid`` only needs a ``.shape`` mapping (axis name -> size), so a
    planning-only ``Grid(sizes=...)`` checks specs for any grid.
    """
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(
            f"spec {spec} has {len(entries)} entries for rank-{len(shape)} "
            f"array of shape {shape} (over-sharded)"
        )
    grid_shape = dict(grid.shape)
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in grid_shape:
                raise ValueError(
                    f"spec {spec} references unknown grid axis {a!r}; "
                    f"grid has {sorted(grid_shape)}"
                )
        group = math.prod(grid_shape[a] for a in axes)
        out.append(entry if dim % group == 0 else None)
    # dims beyond the spec's length are implicitly replicated
    return tuple(out)


def param_shardings(shapes, grid, *, fsdp: bool = True,
                    tp: bool = True) -> dict[str, tuple]:
    """Parameter name -> the spec it takes on ``grid``, for ``shapes``
    (name -> shape; names joined by ``.`` or ``/``, unstacked or with the
    units stacked as the reference's tree holds them): the ``_leaf_spec``
    rules less the axes ``fsdp=False`` (ZeRO-1 parameter mirrors) or
    ``tp=False`` (pure data parallelism) drop, with indivisible dims
    degraded to replicated per ``_validate_spec``."""
    return {name: _validate_spec(
                _filter_spec(_leaf_spec(name, shape), fsdp=fsdp, tp=tp),
                tuple(shape), grid)
            for name, shape in shapes.items()}


def spec_of(p: torch.Tensor):
    """The validated spec ``shard_params`` stored ``p`` under, or None for
    a parameter every rank holds whole."""
    return getattr(p, "spec", None)


def block_of(x: torch.Tensor, spec, grid) -> torch.Tensor:
    """This rank's block of the whole ``x`` under ``spec`` (one entry per
    dim; a dim must divide its axis group: validate the spec first): a
    new tensor of its own storage (a view would keep the whole one
    alive), or ``x`` where the spec cuts nothing."""
    out = x
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size = grid.axis_size(entry)
        if x.shape[dim] % size:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} does not divide by the "
                f"{size} ranks of axis {entry!r}")
        n = out.shape[dim] // size
        out = out.narrow(dim, grid.axis_index(entry) * n, n)
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def gather_block(x: torch.Tensor, spec, grid) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec``, on
    every rank (the inverse of :func:`block_of`; every rank of the spec's
    axes calls it)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = grid.all_gather(x, entry, dim)
    return x


def reshard(x: torch.Tensor, src, dst, grid) -> torch.Tensor:
    """``x``, this rank's block under spec ``src``, as its block under
    ``dst`` (a dim sharded in ``src`` and not in ``dst`` is gathered, one
    sharded in ``dst`` and not in ``src`` is cut); no collective where
    they agree.  Not autograd-aware."""
    src, dst = tuple(src), tuple(dst)
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a is not None and a != b:
            x = grid.all_gather(x, a, dim)
    for dim, (a, b) in enumerate(zip(src, dst)):
        if b is not None and a != b:
            n = x.shape[dim] // grid.axis_size(b)
            x = x.narrow(dim, grid.axis_index(b) * n, n).clone(
                memory_format=torch.contiguous_format)
    return x


class ShardedParameter(nn.Parameter):
    """A parameter holding this rank's block of a whole one: ``spec``, its
    validated spec, and ``full_shape``, the whole one's shape (kept by a
    deep copy)."""

    def __deepcopy__(self, memo):
        out = super().__deepcopy__(memo)
        out.spec, out.full_shape = self.spec, self.full_shape
        return out


def _replace(model: nn.Module, fn) -> nn.Module:
    """Each parameter replaced by ``fn(name, p)`` under its name."""
    for prefix, module in model.named_modules():
        for name, p in list(module.named_parameters(recurse=False)):
            setattr(module, name,
                    fn(f"{prefix}.{name}" if prefix else name, p))
    return model


def shard_params(model: nn.Module, grid, *, fsdp: bool = True,
                 tp: bool = True) -> nn.Module:
    """Replace each parameter by a ``ShardedParameter`` holding this
    rank's block under its validated spec (``param_shardings``' rule for
    the parameter's name and whole shape), under the same name; returns
    ``model``.  A dim that does not divide its axis group stays whole.
    ``fsdp=False`` (ZeRO-1) keeps every parameter whole over the FSDP
    axis, ``tp=False`` (pure data parallelism) over the TP axis."""
    def cut(name, p):
        if spec_of(p) is not None:
            raise ValueError(f"parameter {name} is sharded already")
        full = tuple(p.shape)
        spec = _validate_spec(
            _filter_spec(_leaf_spec(name, full), fsdp=fsdp, tp=tp), full,
            grid)
        spec = spec + (None,) * (len(full) - len(spec))
        out = ShardedParameter(block_of(p.data, spec, grid),
                               requires_grad=p.requires_grad)
        out.spec, out.full_shape = spec, full
        return out

    return _replace(model, cut)


def gather_params(model: nn.Module, grid) -> nn.Module:
    """The inverse of :func:`shard_params`: every parameter whole again
    on every rank (each rank of ``grid`` calls it), a plain
    ``nn.Parameter``; returns ``model``."""
    def whole(name, p):
        if spec_of(p) is None:
            return p
        return nn.Parameter(gather_block(p.data, p.spec, grid),
                            requires_grad=p.requires_grad)

    return _replace(model, whole)
