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
(``_filter_spec``).  ``launch.serve`` calls it with the model's
parameters, ``train.train_step.state_shardings`` with the reference's
stacked tree.

The port keeps every weight whole on every rank until the sharding
rules of ROADMAP A8b land: ``launch.serve`` computes these specs on its
grid and reports the bytes a rank would hold under them, and slices
nothing.
"""
from __future__ import annotations

import math

from torch import nn

__all__ = ["param_specs", "param_shardings", "_filter_spec",
           "_leaf_spec", "_validate_spec"]

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
