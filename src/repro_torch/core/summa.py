"""Task-based 2D SUMMA as per-rank programs on a ``Grid``.

The port of ``repro.core.summa``.  The reference runs each strategy as one
``shard_map`` program over a mesh; here every rank runs the same plan
interpreter on its own shards and talks to its grid row and column
through ``torch.distributed`` (``core.grid``).  On the 1x1 grid of one
card every collective is the identity and the executors reduce to their
local work.

* ``_exec_procedural`` — the paper's baseline: a sequential K-step loop;
  each step broadcasts one column-panel of A along grid rows and one
  row-panel of B along grid columns, waits, then does the rank-k update.
* ``_exec_taskbased`` — the paper's contribution (§3.2): *multiple issue*
  of ``I`` iterations (Eq. 1) as an ``I``-deep prefetch of asynchronous
  panel broadcasts.  The broadcasts for step ``k+I`` are issued before
  the product of step ``k`` and waited on only when consumed, so
  communication overlaps the local GEMM.
* ``_exec_allgather`` — the ``I = K_steps`` extreme: one all-gather per
  operand, then one local GEMM.
* ``_exec_sparse_dag`` — block-sparse: only globally-live panels are
  broadcast and multiplied, on masked operands.
* ``_exec_sparse_bsmm`` — the plan's per-device refinement: live panels
  are gathered once, then the block-sparse CUDA kernel (kernels/bsmm.py)
  walks *this rank's* CSR column map, so blocks dead for this grid
  row/column are never loaded or multiplied.

A panel broadcast is ``dist.broadcast`` from its owner; the reference's
masked-psum idiom is a static-SPMD workaround this port does not need.

Data layout: A is ``(M, K)``, B is ``(K, N)`` and C is ``(M, N)``, each
cut into ``p_row x p_col`` tiles; rank ``(i, j)`` holds tile ``(i, j)``
of each.  The K dimension is split into ``k_blocks`` panels, each inside
one rank's shard.

Routes of the reference not ported yet raise ``NotImplementedError``
naming their ROADMAP item: A-/B-stationary schedules and the one-sided
pull route (A7), the rank-sparse factor route (A2), ``summa_25d_matmul``
and the digest-keyed executable cache (A3).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core.grid import Grid

__all__ = [
    "SummaConfig",
    "multi_issue_limit",
    "resolve_multi_issue",
    "reference_matmul",
    "reference_blocksparse_matmul",
    "execute_plan",
]

Strategy = Literal["procedural", "taskbased", "allgather"]


def multi_issue_limit(p_row: int, p_col: int, k_steps: int) -> int:
    """Paper Eq. (1): the number of concurrently scheduled iterations I."""
    if p_row < 2 or p_col < 2:
        return 2
    if p_row >= k_steps and p_col >= k_steps:
        return k_steps
    return min(p_row, p_col)


def resolve_multi_issue(
    p_row: int, p_col: int, k_steps: int, lookahead: int | None = None
) -> int:
    """The executed multiple-issue window: ``lookahead`` when given, Eq. (1)
    otherwise — always clamped to ``[1, max(k_steps, 1)]`` so degenerate
    schedules (k_steps of 0 or 1, windows beyond the panel count) stay
    well-formed."""
    cap = max(k_steps, 1)
    if lookahead is not None:
        return max(1, min(lookahead, cap))
    return max(1, min(multi_issue_limit(p_row, p_col, k_steps), cap))


@dataclasses.dataclass(frozen=True)
class SummaConfig:
    """Configuration for a distributed SUMMA matmul on a ``Grid``.

    ``row_axis``/``col_axis`` name grid axes; a tuple of names plans over
    their product, as in the reference (execution needs single names).

    ``local_matmul`` keeps the reference's values so plans compare field
    by field: ``"xla"`` means ``torch.matmul`` here, and ``"pallas"``
    means this package's hand-written kernels (``kernels.tiled_matmul``
    for dense panels, ``kernels.bsmm`` for the block-sparse update).
    """

    grid: Grid
    row_axis: str | tuple[str, ...] = "data"
    col_axis: str | tuple[str, ...] = "model"
    strategy: Strategy = "taskbased"
    k_blocks: int | None = None  # number of K panels (over-decomposition)
    lookahead: int | None = None  # None => paper Eq. (1)
    accum_dtype: torch.dtype = torch.float32
    local_matmul: Literal["xla", "pallas"] = "xla"

    def _axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            out = 1
            for a in axis:
                out *= self.grid.shape[a]
            return out
        return self.grid.shape[axis]

    @property
    def p_row(self) -> int:
        return self._axis_size(self.row_axis)

    @property
    def p_col(self) -> int:
        return self._axis_size(self.col_axis)

    def resolve_k_blocks(self, k: int) -> int:
        kb = self.k_blocks
        if kb is None:
            # default: one panel per grid column (classic SUMMA)
            kb = max(self.p_col, self.p_row)
        lcm = math.lcm(self.p_row, self.p_col)
        if kb % lcm and kb not in (self.p_row, self.p_col):
            raise ValueError(
                f"k_blocks={kb} must be a multiple of lcm(grid)={lcm}"
            )
        if k % kb:
            raise ValueError(f"K={k} not divisible by k_blocks={kb}")
        return kb

    def resolve_lookahead(self, k_steps: int) -> int:
        """The executed multiple-issue window (see ``resolve_multi_issue``)."""
        return resolve_multi_issue(
            self.p_row, self.p_col, k_steps, self.lookahead
        )


# ---------------------------------------------------------------------------
# Plain oracles
# ---------------------------------------------------------------------------


def reference_matmul(a: torch.Tensor, b: torch.Tensor,
                     accum_dtype=torch.float32) -> torch.Tensor:
    """Oracle: plain matmul accumulated in ``accum_dtype``."""
    return torch.matmul(a.to(accum_dtype), b.to(accum_dtype)).to(a.dtype)


def reference_blocksparse_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    a_mask: np.ndarray,
    b_mask: np.ndarray,
    accum_dtype=torch.float32,
) -> torch.Tensor:
    """Oracle for block-sparse matmul: zero masked blocks, then matmul."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {a.shape} @ {b.shape}")
    if a_mask.shape[1] != b_mask.shape[0]:
        raise ValueError("A col-blocks must equal B row-blocks")
    return reference_matmul(
        _apply_block_mask(a, a_mask), _apply_block_mask(b, b_mask),
        accum_dtype,
    )


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _bcast_panel(panel, owner: int, axis, grid: Grid, *, async_op=False):
    """Broadcast ``panel`` from ``owner`` along ``axis``: ``(tensor, work)``."""
    return grid.broadcast(panel, owner, axis, async_op=async_op)


def _wait(*works) -> None:
    for work in works:
        if work is not None:
            work.wait()


def _local_dot(a_panel, b_panel, accum, cfg: SummaConfig) -> torch.Tensor:
    """``accum += a_panel @ b_panel``, in place.

    ``local_matmul="pallas"`` takes the hand-written tiled kernel, whose
    product is cast to the operand dtype before it is added (the
    reference's ``kernels.ops.tiled_matmul`` semantics); ``"xla"`` runs
    ``torch.matmul`` in ``accum_dtype``.  The reference's autotune-cache
    consult is left out: its empty cache changes nothing, and
    ``kernels/autotune.py`` is queued (ROADMAP A4).
    """
    if cfg.local_matmul == "pallas":
        from repro_torch.kernels import ops as kops

        return accum.add_(
            kops.tiled_matmul(a_panel, b_panel, accum_dtype=cfg.accum_dtype)
        )
    return accum.addmm_(a_panel.to(cfg.accum_dtype), b_panel.to(cfg.accum_dtype))


def _panel_slices(a_loc, b_loc, k, kb_width, t_a, t_b):
    """The k-th K-panel slices (views) + their owners from local shards.

    Global panel k lives in A's grid-column ``k // t_a`` at local panel
    index ``k % t_a`` and in B's grid-row ``k // t_b`` at local index
    ``k % t_b`` (contiguous panel schedule).  A's panel is a column slice
    with row stride ``a_loc.stride(0)``, which the kernel takes as is.
    """
    ka, kb = (k % t_a) * kb_width, (k % t_b) * kb_width
    a_panel = a_loc[:, ka:ka + kb_width]
    b_panel = b_loc[kb:kb + kb_width, :]
    return a_panel, b_panel, k // t_a, k // t_b


def _zeros_c(a_loc, b_loc, cfg) -> torch.Tensor:
    return torch.zeros(
        (a_loc.shape[0], b_loc.shape[1]), dtype=cfg.accum_dtype,
        device=a_loc.device,
    )


# ---------------------------------------------------------------------------
# Plan interpreters (one rank's program)
# ---------------------------------------------------------------------------


def _exec_procedural(a_loc, b_loc, plan):
    """Paper baseline: each step's broadcasts complete before its update."""
    cfg = plan.cfg
    grid = cfg.grid
    w = plan.kb_width
    t_a, t_b = a_loc.shape[1] // w, b_loc.shape[0] // w
    c = _zeros_c(a_loc, b_loc, cfg)
    for k in range(plan.k_steps):
        a_panel, b_panel, owner_col, owner_row = _panel_slices(
            a_loc, b_loc, k, w, t_a, t_b
        )
        a_bc, _ = _bcast_panel(a_panel, owner_col, cfg.col_axis, grid)
        b_bc, _ = _bcast_panel(b_panel, owner_row, cfg.row_axis, grid)
        _local_dot(a_bc, b_bc, c, cfg)
    return c


def _exec_taskbased(a_loc, b_loc, plan):
    """Multiple-issue SUMMA: I-deep panel prefetch pipeline (paper §3.2).

    Up to ``I`` steps' broadcasts are in flight.  Step ``k`` issues the
    broadcasts of step ``k+I`` before it multiplies panel ``k``, and waits
    on panel ``k``'s own broadcasts only then.
    """
    cfg = plan.cfg
    grid = cfg.grid
    w = plan.kb_width
    k_steps = plan.k_steps
    t_a, t_b = a_loc.shape[1] // w, b_loc.shape[0] // w
    lookahead = plan.resolve_lookahead(k_steps)

    def issue(k):
        a_panel, b_panel, owner_col, owner_row = _panel_slices(
            a_loc, b_loc, k, w, t_a, t_b
        )
        return (
            _bcast_panel(a_panel, owner_col, cfg.col_axis, grid, async_op=True),
            _bcast_panel(b_panel, owner_row, cfg.row_axis, grid, async_op=True),
        )

    in_flight = collections.deque(issue(k) for k in range(lookahead))
    c = _zeros_c(a_loc, b_loc, cfg)
    for k in range(k_steps):
        (a_bc, a_work), (b_bc, b_work) = in_flight.popleft()
        if k + lookahead < k_steps:
            in_flight.append(issue(k + lookahead))
        _wait(a_work, b_work)
        _local_dot(a_bc, b_bc, c, cfg)
    return c


def _exec_allgather(a_loc, b_loc, plan):
    """I = K extreme of Eq. (1): gather every panel up-front."""
    cfg = plan.cfg
    a_full = cfg.grid.all_gather(a_loc, cfg.col_axis, dim=1)
    b_full = cfg.grid.all_gather(b_loc, cfg.row_axis, dim=0)
    return _local_dot(a_full, b_full, _zeros_c(a_loc, b_loc, cfg), cfg)


def _bcast_live_panels(a_loc, b_loc, plan):
    """Broadcast every globally-live panel; all are issued before any is
    waited on.  Returns the two lists of broadcast panels."""
    cfg = plan.cfg
    grid = cfg.grid
    w = plan.kb_width
    t_a, t_b = a_loc.shape[1] // w, b_loc.shape[0] // w
    issued = []
    for kk in plan.live_panels:
        a_panel, b_panel, owner_col, owner_row = _panel_slices(
            a_loc, b_loc, kk, w, t_a, t_b
        )
        issued.append((
            _bcast_panel(a_panel, owner_col, cfg.col_axis, grid, async_op=True),
            _bcast_panel(b_panel, owner_row, cfg.row_axis, grid, async_op=True),
        ))
    for (_, a_work), (_, b_work) in issued:
        _wait(a_work, b_work)
    return [a for (a, _), _ in issued], [b for _, (b, _) in issued]


def _exec_sparse_dag(a_loc, b_loc, plan):
    """Globally-live panels only: every surviving broadcast, then one
    rank-k update per live panel on the masked operands."""
    cfg = plan.cfg
    c = _zeros_c(a_loc, b_loc, cfg)
    for a_bc, b_bc in zip(*_bcast_live_panels(a_loc, b_loc, plan)):
        _local_dot(a_bc, b_bc, c, cfg)
    return c


def _exec_sparse_bsmm(a_loc, b_loc, cols_loc, plan):
    """Per-device block-sparse rank-k update through the BSMM kernel.

    Gathers the globally-live panels (same broadcast traffic as the DAG
    executor), then runs ONE kernel over the gathered operands with this
    rank's CSR column map: blocks dead for this grid row/column are never
    loaded nor multiplied, so local FLOPs follow the per-device fill-in
    the planner computed.
    """
    from repro_torch.kernels.ops import bsmm_cols

    cfg = plan.cfg
    a_parts, b_parts = _bcast_live_panels(a_loc, b_loc, plan)
    a_g = torch.cat(a_parts, dim=1)  # (m_loc, L*kb)
    b_g = torch.cat(b_parts, dim=0)  # (L*kb, n_loc)
    del a_parts, b_parts
    bm, bk, bn = plan.local_block
    return bsmm_cols(
        a_g, b_g, cols_loc, bm=bm, bk=bk, bn=bn, out_dtype=cfg.accum_dtype
    )


_EXEC_IMPLS = {
    "procedural": _exec_procedural,
    "taskbased": _exec_taskbased,
    "allgather": _exec_allgather,
}


# ---------------------------------------------------------------------------
# Plan execution
# ---------------------------------------------------------------------------


def execute_plan(
    a_loc: torch.Tensor,
    b_loc: torch.Tensor,
    plan,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """This rank's tile of C = A @ B under a ``core.plan.MatmulPlan``.

    ``a_loc``/``b_loc`` are this rank's tiles of the operands padded to
    ``plan.padded_shapes`` (``core.api.DistributedMatmul`` cuts them); the
    result is this rank's ``(m_pad/p_row, n_pad/p_col)`` tile of C.  Runs
    eagerly: the reference's digest-keyed executable cache is queued
    (ROADMAP A3).
    """
    cfg = plan.cfg
    _check_plan_operands(a_loc, b_loc, plan)
    if plan.stationarity != "C":
        raise NotImplementedError(
            f"stationarity={plan.stationarity!r}: A-/B-stationary execution "
            "is not ported yet (ROADMAP A7)"
        )
    if plan.comm_mode != "broadcast":
        raise NotImplementedError(
            f"comm_mode={plan.comm_mode!r}: the one-sided pull route is not "
            "ported yet (ROADMAP A7)"
        )
    out_dtype = out_dtype or a_loc.dtype
    row, col = cfg.grid.axis_index(cfg.row_axis), cfg.grid.axis_index(
        cfg.col_axis
    )
    m_loc, k_loc = a_loc.shape
    n_loc = b_loc.shape[1]
    if plan.a_mask is not None:
        # Zero masked blocks so padded/garbage data cannot contribute.
        a_loc = _apply_block_mask(
            a_loc, plan.a_mask, _block_of(plan.a_mask, plan.m_pad, plan.k_pad),
            origin=(row * m_loc, col * k_loc),
        )
        b_loc = _apply_block_mask(
            b_loc, plan.b_mask, _block_of(plan.b_mask, plan.k_pad, plan.n_pad),
            origin=(row * b_loc.shape[0], col * n_loc),
        )
    if plan.local_impl == "bsmm":
        cols = torch.as_tensor(plan.local_cols[row, col], device=a_loc.device)
        c = _exec_sparse_bsmm(a_loc, b_loc, cols, plan)
    elif plan.local_impl in ("masked", "ranksparse"):
        # Rank plans given dense-stored operands run the masked DAG, as in
        # the reference: without factors there is nothing rank-sized to
        # multiply.
        c = _exec_sparse_dag(a_loc, b_loc, plan)
    else:
        c = _EXEC_IMPLS[cfg.strategy](a_loc, b_loc, plan)
    return _filter_c(c.to(out_dtype), plan, origin=(row * m_loc, col * n_loc))


def _check_plan_operands(a_loc, b_loc, plan) -> None:
    (mp, kp), (_, np_) = plan.padded_shapes
    want_a = (mp // plan.p_row, kp // plan.p_col)
    want_b = (kp // plan.p_row, np_ // plan.p_col)
    if tuple(a_loc.shape) != want_a or tuple(b_loc.shape) != want_b:
        raise ValueError(
            f"local operands {tuple(a_loc.shape)} @ {tuple(b_loc.shape)} do "
            f"not match the plan's tiles {want_a} @ {want_b}"
        )


def _block_of(mask: np.ndarray, rows: int, cols: int) -> tuple[int, int]:
    return rows // mask.shape[0], cols // mask.shape[1]


def _filter_c(c_loc: torch.Tensor, plan, origin=(0, 0)) -> torch.Tensor:
    """Apply the plan's output filter: dead C blocks are zeroed, so an
    execution can never populate blocks the output structure excludes."""
    c_mask = plan.c_mask
    if c_mask is None:
        return c_loc
    return _apply_block_mask(
        c_loc, c_mask, _block_of(c_mask, plan.m_pad, plan.n_pad), origin
    )


def _apply_block_mask(
    x: torch.Tensor,
    mask: np.ndarray,
    block: tuple[int, int] | None = None,
    origin: tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Zero the masked blocks of ``x``, a tile at ``origin`` of a matrix
    blocked ``block`` (default: ``x`` is the whole matrix, cut evenly by
    the ``(Rb, Cb)`` mask).  Returns a new tensor."""
    r, c = x.shape
    rb, cb = mask.shape
    if block is None:
        if r % rb or c % cb:
            raise ValueError(
                f"array {tuple(x.shape)} not divisible by mask {mask.shape}"
            )
        block = (r // rb, c // cb)
    dev = x.device
    rows = torch.arange(origin[0], origin[0] + r, device=dev) // block[0]
    cols = torch.arange(origin[1], origin[1] + c, device=dev) // block[1]
    keep = torch.as_tensor(np.asarray(mask, bool), device=dev)[rows][:, cols]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=dev))
