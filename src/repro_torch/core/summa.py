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

The rank-sparse factor route (``execute_rank_plan``) multiplies A given
as low-rank block factors U·V (``core.sparsity.RankCSR`` laid out by
``rank_operands``):

* ``_exec_ranksparse`` — ``local_matmul="xla"``: per live panel a
  width-``r_k`` U panel and V rows are broadcast, with the reference's two
  per-panel fallbacks to a dense panel; the factored panels resolve as
  ``U·(V·B)`` in batched products.
* ``_exec_ranksparse_grouped`` — ``local_matmul="pallas"``: stage 1,
  every block's ``V·B_panel``, runs through the grouped-GEMM CUDA kernel
  (kernels/grouped_gemm.py); stage 2 applies U in one batched product.
* ``_exec_ranksparse_pull`` — ``comm_mode="pull"``: the factors are
  all-gathered and read per panel; arithmetic identical to
  ``_exec_ranksparse``, so the two agree bitwise.

Both factored stages run over chunks of local block rows whose stage-1
output stays within ``RANK_CHUNK_BYTES``: at the paper's size the whole
stage-1 output of one card would be 128 GiB.

Two more routes of mask plans (repro.spgemm):

* ``comm_mode="pull"`` — the one-sided gets read exactly the live panels
  in the masked DAG's order, which is what ``_exec_sparse_dag``
  broadcasts and multiplies, so pull plans run it: pull equals broadcast
  bitwise, and only live panels move.  The fetch-level cost model that
  sets pull apart (factor-1.0 bytes, owner-clock contention) lives in
  ``sched.taskgraph``;
* ``_exec_stationary`` — ``stationarity="A"``/``"B"``: one local product
  of the stationary tile with the re-laid-out other operand, then a
  reduce-scatter of the partial C into C's layout.

Every local panel product goes through ``_local_dot``, which consults
the kernel autotune cache (``kernels.autotune``) lookup-only: an empty or
disabled cache changes nothing.

``execute_plan`` and ``execute_rank_plan`` dispatch through a
process-wide executable cache keyed, as in the reference, by the plan's
digest, its local route, its window and the dtypes (and the kernel
autotune cache's fingerprint when that cache is not empty).  There is no
tracer here: an executable is a callable built once per key that holds
what the eager route derives from the plan alone (the device copies of
the block masks and of ``bsmm``'s column map) and runs the same kernels,
in the same order, on the same operands, so it equals the eager route
bitwise; ``retraces`` counts builds.  ``compiled=False`` runs eagerly.
``summa_matmul`` and ``summa_blocksparse_matmul`` are the reference's
thin plan-and-execute wrappers over global operands.

``summa_25d_matmul`` is the paper's 2.5D remark: the operands are
replicated over a third grid axis, each replica runs a disjoint share of
the K panels through ``_exec_taskbased(k_steps=..., k_start=...)``, and
``Grid.all_reduce`` sums the partial C's over the replicas.

Row and column axes may be tuples of grid axes (``("pod", "data")``):
every collective and ``local_tile``/``gather_tiles`` take them, ordered
as a mesh orders a tuple axis (``core.grid``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Literal

import numpy as np
import torch

from repro_torch.analysis.spans import count, span, spanned
from repro_torch.core.grid import Grid
from repro_torch.kernels.autotune import autotune_cache, cache_fingerprint

__all__ = [
    "SummaConfig",
    "multi_issue_limit",
    "resolve_multi_issue",
    "reference_matmul",
    "reference_blocksparse_matmul",
    "reference_ranksparse_matmul",
    "execute_plan",
    "rank_operands",
    "execute_rank_plan",
    "executable_cache_stats",
    "clear_executable_cache",
    "warm_plan_executable",
    "summa_matmul",
    "summa_blocksparse_matmul",
    "summa_25d_matmul",
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

    ``row_axis``/``col_axis`` name grid axes; a tuple of names is their
    product, as in the reference, for planning and execution alike.

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

    @property
    def p_row(self) -> int:
        return self.grid.axis_size(self.row_axis)

    @property
    def p_col(self) -> int:
        return self.grid.axis_size(self.col_axis)

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


def reference_ranksparse_matmul(
    a_ranks,
    b: torch.Tensor,
    b_mask: np.ndarray | None = None,
    accum_dtype=torch.float32,
) -> torch.Tensor:
    """Oracle for rank-sparse matmul: densify the ``RankCSR``, then matmul
    (optionally with B's block mask applied)."""
    a = torch.as_tensor(a_ranks.to_dense(), device=b.device).to(b.dtype)
    if b_mask is not None:
        mb, kb = a_ranks.rank_map().ranks.shape
        return reference_blocksparse_matmul(
            a, b, np.ones((mb, kb), dtype=bool), b_mask, accum_dtype
        )
    return reference_matmul(a, b, accum_dtype)


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
    """``accum += a_panel @ b_panel``, in place; consults the kernel
    autotune cache.

    ``cfg.local_matmul`` is the static policy: ``"pallas"`` takes the
    hand-written tiled kernel, whose product is cast to the operand dtype
    before it is added (the reference's ``kernels.ops.tiled_matmul``
    semantics; the add is the span ``exec.accumulate``); ``"xla"`` runs
    ``torch.matmul`` in ``accum_dtype``.  When the autotune cache holds a
    measured ``pallas`` or ``xla`` winner for this panel shape's bucket,
    that route overrides the policy.  The consult is a lookup only, so a
    cold or disabled cache launches exactly what the policy launches; a
    cache measured on another kind of device is refused
    (``KernelAutotuner.lookup``).
    """
    route = "pallas" if cfg.local_matmul == "pallas" else "xla"
    entry = autotune_cache().lookup(
        a_panel.shape[0], a_panel.shape[1], b_panel.shape[1],
        dtype=a_panel.dtype, device=a_panel.device,
    )
    if entry is not None and entry["winner"] in ("pallas", "xla"):
        route = entry["winner"]
    if route == "pallas":
        from repro_torch.kernels import ops as kops

        product = kops.tiled_matmul(a_panel, b_panel,
                                    accum_dtype=cfg.accum_dtype)
        with span("exec.accumulate", device=accum.device):
            return accum.add_(product)
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


def _exec_procedural(a_loc, b_loc, plan, *, k_steps=None, k_start=0):
    """Paper baseline: each step's broadcasts complete before its update.

    ``k_steps`` panels from panel ``k_start`` on (default: all of them);
    the 2.5D route gives each replica its own range."""
    cfg = plan.cfg
    grid = cfg.grid
    w = plan.kb_width
    k_steps = plan.k_steps if k_steps is None else k_steps
    t_a, t_b = a_loc.shape[1] // w, b_loc.shape[0] // w
    c = _zeros_c(a_loc, b_loc, cfg)
    for k in range(k_steps):
        a_panel, b_panel, owner_col, owner_row = _panel_slices(
            a_loc, b_loc, k + k_start, w, t_a, t_b
        )
        a_bc, _ = _bcast_panel(a_panel, owner_col, cfg.col_axis, grid)
        b_bc, _ = _bcast_panel(b_panel, owner_row, cfg.row_axis, grid)
        _local_dot(a_bc, b_bc, c, cfg)
    return c


def _exec_taskbased(a_loc, b_loc, plan, *, k_steps=None, k_start=0):
    """Multiple-issue SUMMA: I-deep panel prefetch pipeline (paper §3.2).

    Up to ``I`` steps' broadcasts are in flight.  Step ``k`` issues the
    broadcasts of step ``k+I`` before it multiplies panel ``k``, and waits
    on panel ``k``'s own broadcasts only then.  ``k_steps`` panels from
    panel ``k_start`` on (default: all of them), the window resolved over
    that range: the 2.5D variant gives each replica its own K sub-range.
    """
    cfg = plan.cfg
    grid = cfg.grid
    w = plan.kb_width
    k_steps = plan.k_steps if k_steps is None else k_steps
    t_a, t_b = a_loc.shape[1] // w, b_loc.shape[0] // w
    lookahead = plan.resolve_lookahead(k_steps)

    def issue(k):
        a_panel, b_panel, owner_col, owner_row = _panel_slices(
            a_loc, b_loc, k + k_start, w, t_a, t_b
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


def _exec_allgather(a_loc, b_loc, plan, *, k_steps=None, k_start=0):
    """I = K extreme of Eq. (1): gather every panel up-front.  It takes
    ``k_steps``/``k_start`` and ignores them, as the reference's does (no
    caller passes them: the 2.5D route runs the task-based executor)."""
    del k_steps, k_start
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


def _exec_stationary(a_loc, b_loc, plan):
    """A-/B-stationary schedule (``plan.stationarity`` "A" or "B").

    The stationary operand keeps its (row, col) tile; the other is re-laid
    out with K over the opposite grid axis — the reference's in_specs
    ``P(col_axis, None)`` for B under "A", ``P(None, row_axis)`` for A
    under "B" (``_k_shard``) — and one local product of the two gives this
    rank's partial C, which a reduce-scatter along that axis sums into
    C's tile.  No K pipeline: masked blocks were zeroed by the caller, so
    structure prunes only at the value level, as in the reference.

    The re-layout delivers only this rank's K shard, point to point, as
    ``sched.taskgraph._emit_stationary`` prices it: each rank receives its
    shard less what its own tile already holds of it (the task graph's
    relay carries ``BCAST_FACTOR`` times the shard, the reference's
    broadcast-as-allreduce); the recorder's ``grid.recv_bytes`` in the
    span ``grid.exchange`` counts what this rank received.  On the 1x1
    grid nothing moves.
    """
    cfg = plan.cfg
    grid = cfg.grid
    if plan.stationarity == "A":
        b_rel = _k_shard(b_loc, cfg, k_dim=0)
        part = torch.zeros((a_loc.shape[0], b_rel.shape[1]),
                           dtype=cfg.accum_dtype, device=a_loc.device)
        _local_dot(a_loc, b_rel, part, cfg)
        return grid.reduce_scatter(part, cfg.col_axis, dim=1)
    a_rel = _k_shard(a_loc, cfg, k_dim=1)
    part = torch.zeros((a_rel.shape[0], b_loc.shape[1]),
                       dtype=cfg.accum_dtype, device=b_loc.device)
    _local_dot(a_rel, b_loc, part, cfg)
    return grid.reduce_scatter(part, cfg.row_axis, dim=0)


def _k_shard(x_loc, cfg, *, k_dim: int) -> torch.Tensor:
    """This rank's K shard of a moving operand, whole along its other
    dimension: B's rows ``[j·w, (j+1)·w)`` (``k_dim=0``, ``j`` this rank's
    column, ``w = K/p_col``) or A's columns ``[i·w, (i+1)·w)``
    (``k_dim=1``, ``i`` its row, ``w = K/p_row``).

    ``x_loc`` is this rank's tile; K is tiled over one grid axis (B's
    rows over the row axis, A's columns over the column axis) and the
    other dimension over the other axis, which also numbers the shards.
    Every rank sends each peer the part of its tile that lies in the
    peer's shard and receives the same from each peer whose tile meets
    its own shard; the parts it holds itself are copied.
    """
    grid = cfg.grid
    tile_axis, shard_axis = ((cfg.row_axis, cfg.col_axis) if k_dim == 0
                             else (cfg.col_axis, cfg.row_axis))
    k_tile, other = x_loc.shape[k_dim], x_loc.shape[1 - k_dim]
    p_k, p_s = grid.axis_size(tile_axis), grid.axis_size(shard_axis)
    if p_k == p_s == 1:  # the tile is the shard
        return x_loc
    w = k_tile * p_k // p_s
    me_k, me_s = grid.axis_index(tile_axis), grid.axis_index(shard_axis)
    shape = [w, w]
    shape[1 - k_dim] = other * p_s
    out = torch.empty(shape, dtype=x_loc.dtype, device=x_loc.device)

    def meet(shard: int, tile: int) -> tuple[int, int]:
        """K range of ``shard`` inside the tile ``tile``, in global K."""
        return max(shard * w, tile * k_tile), min((shard + 1) * w,
                                                  (tile + 1) * k_tile)

    sends, recvs, places = [], [], []
    for t in range(p_k):
        for s in range(p_s):
            peer = grid.rank_at({tile_axis: t, shard_axis: s})
            lo, hi = meet(me_s, t)  # what (t, s) holds of my shard
            if lo < hi:
                dest = out.narrow(k_dim, lo - me_s * w, hi - lo).narrow(
                    1 - k_dim, s * other, other)
                if peer == grid.rank:
                    dest.copy_(x_loc.narrow(k_dim, lo - t * k_tile, hi - lo))
                else:
                    buf = torch.empty(dest.shape, dtype=x_loc.dtype,
                                      device=x_loc.device)
                    recvs.append((peer, buf))
                    places.append(dest)
            lo, hi = meet(s, me_k)  # what my tile holds of (t, s)'s shard
            if lo < hi and peer != grid.rank:
                sends.append((peer, x_loc.narrow(k_dim, lo - me_k * k_tile,
                                                 hi - lo)))
    grid.exchange(sends, recvs)
    for dest, (_, buf) in zip(places, recvs):
        dest.copy_(buf)
    return out


def _exec_sparse_bsmm(a_loc, b_loc, cols_loc, plan, *, blocks,
                      cols_dev=None, columns=None):
    """Per-device block-sparse rank-k update through the BSMM kernel.

    Gathers the globally-live panels (same broadcast traffic as the DAG
    executor), then runs ONE kernel over the gathered operands with this
    rank's column map (``_bsmm_walk``'s: the planner's ``plan.local_cols``
    entry, or where B's mask kills some of its products that map
    intersected with B's, a list a 256-column tile; checked and counted on
    the host by ``bsmm_cols``, unless the caller holds its copy on the
    operands' device, ``cols_dev``, and its count, ``columns``):
    blocks dead for this grid row/column, and blocks of B dead under a
    tile, are never loaded nor multiplied, so local FLOPs follow the
    useful block products.  ``blocks`` is ``_bsmm_walk``'s count, added
    to the recorder's counters.
    """
    from repro_torch.kernels.ops import bsmm_cols

    cfg = plan.cfg
    with span("exec.panels", device=a_loc.device):
        a_parts, b_parts = _bcast_live_panels(a_loc, b_loc, plan)
        a_g = torch.cat(a_parts, dim=1)  # (m_loc, L*kb)
        b_g = torch.cat(b_parts, dim=0)  # (L*kb, n_loc)
        del a_parts, b_parts
    count("bsmm.blocks_multiplied", blocks[0])
    count("bsmm.blocks_useful", blocks[1])
    bm, bk, bn = plan.local_block
    return bsmm_cols(
        a_g, b_g, cols_loc, bm=bm, bk=bk, bn=bn, out_dtype=cfg.accum_dtype,
        device_cols=cols_dev, columns=columns,
    )


# ---------------------------------------------------------------------------
# Rank-sparse executors (A given as block factors U·V)
# ---------------------------------------------------------------------------

#: bytes of stage-1 output (V·B rows) one chunk of local block rows may
#: hold.  At the paper's size (N = 32768, 128 live panels of r_pad 64) one
#: block row's stage-1 output is 1 GiB, so a chunk takes 8 block rows.
RANK_CHUNK_BYTES = 8 << 30


def _rank_row_chunk(mb_loc: int, bytes_per_row: int) -> int:
    """Local block rows per chunk of the factored stages."""
    return max(1, min(mb_loc, RANK_CHUNK_BYTES // max(bytes_per_row, 1)))


def _rank_panel_widths(plan) -> dict[int, int]:
    """Static per-live-panel factor width: the max block rank in that
    panel's (padded) column of the rank grid (>= 1 on live panels)."""
    return {
        kk: max(int(plan.a_ranks[:, kk].max()), 1)
        for kk in plan.live_panels
    }


def _densify(u3: torch.Tensor, v3: torch.Tensor, cfg) -> torch.Tensor:
    """The dense ``(mb·bm, bk)`` A panel of block factors ``u3`` (mb, bm, r)
    and ``v3`` (mb, r, bk), in ``accum_dtype``, cast to ``u3``'s dtype.
    Both factors are made contiguous first, so every route that densifies
    the same values gets the same bits."""
    a = torch.bmm(u3.contiguous().to(cfg.accum_dtype),
                  v3.contiguous().to(cfg.accum_dtype))
    return a.reshape(-1, v3.shape[2]).to(u3.dtype)


def _rank_update(dense, factored, m_loc, n_loc, cfg, device):
    """This rank's C from its resolved panels.

    ``dense`` lists ``(a_panel, b_panel)`` pairs, each a rank-k update
    through ``_local_dot``; ``factored`` lists ``(u3, v3, b_panel)``
    triples (U (mb, bm, r_k), V (mb, r_k, bk)), resolved as ``U·(V·B)``:
    per chunk of local block rows, every panel's ``V·B`` lands in one
    ``(rows, Σr_k, n_loc)`` buffer and one batched product over the
    concatenated rank axis adds ``U_cat·W`` to C's rows.  The chunking
    reorders the reference's sum over (panel, rank) only by rows, so the
    result agrees with it within the fp32 tolerance.
    """
    acc = cfg.accum_dtype
    c = torch.zeros((m_loc, n_loc), dtype=acc, device=device)
    for a_panel, b_panel in dense:
        _local_dot(a_panel, b_panel, c, cfg)
    if not factored:
        return c
    mb_loc, bm = factored[0][0].shape[:2]
    widths = [v3.shape[1] for _, v3, _ in factored]
    r_sum = sum(widths)
    u_cat = torch.cat([u3.to(acc) for u3, _, _ in factored], dim=2)
    b_parts = [b_panel.contiguous().to(acc) for _, _, b_panel in factored]
    step = _rank_row_chunk(mb_loc, r_sum * n_loc * c.element_size())
    for i0 in range(0, mb_loc, step):
        i1 = min(i0 + step, mb_loc)
        w = torch.empty((i1 - i0, r_sum, n_loc), dtype=acc, device=device)
        off = 0
        for (_, v3, _), b_p, r in zip(factored, b_parts, widths):
            w[:, off:off + r] = torch.matmul(
                v3[i0:i1].contiguous().to(acc), b_p
            )
            off += r
        c[i0 * bm:i1 * bm] += torch.bmm(u_cat[i0:i1], w).reshape(-1, n_loc)
        del w  # the next chunk's buffer is not allocated beside this one
    return c


def _rank_geometry(u_loc, v_loc, b_loc, plan, r_pad):
    """``(bk, m_loc, n_loc, mb_loc, bm, t_a, t_b)`` of a rank execution."""
    bk = plan.kb_width
    m_loc, n_loc = u_loc.shape[0], b_loc.shape[1]
    mb_loc = v_loc.shape[0] // r_pad
    t_a = plan.k_steps // max(plan.cfg.p_col, 1) or 1
    return bk, m_loc, n_loc, mb_loc, m_loc // mb_loc, t_a, b_loc.shape[0] // bk


def _exec_ranksparse(u_loc, v_loc, b_loc, plan, *, r_pad: int):
    """Block-rank-sparse rank-k updates from factorized A panels.

    For live panel ``kk`` this broadcasts a width-``r_k`` U panel, the
    matching V rows and B's dense panel, then evaluates every local block
    row as ``U @ (V @ B)``, FLOPs following the panel rank.  Two
    per-panel fallbacks, as in the reference (and the planner's model):

    * comm — past r* = bm·bk/(bm+bk) the factors outweigh the dense
      panel, so the owner column reconstructs it and the dense panel is
      broadcast instead;
    * compute — near the threshold the dense dot beats the two-stage
      contraction (``RANK_COMPUTE_MARGIN``); the factors travel and the
      receivers reconstruct.

    Every broadcast is issued before any is waited on.  Rank raggedness
    within a panel is carried by zero factor columns (the executed width
    is the panel max).
    """
    from repro_torch.core.sparsity import (
        rank_panel_factored_comm,
        rank_panel_factored_compute,
    )

    cfg = plan.cfg
    grid = cfg.grid
    bk, m_loc, n_loc, mb_loc, bm, t_a, t_b = _rank_geometry(
        u_loc, v_loc, b_loc, plan, r_pad
    )
    col = grid.axis_index(cfg.col_axis)
    widths = _rank_panel_widths(plan)
    issued = []
    for kk in plan.live_panels:
        r_k = min(widths[kk], r_pad)
        owner_col, owner_row = kk // t_a, kk // t_b
        s = kk % t_a
        u3 = u_loc[:, s * r_pad:s * r_pad + r_k].reshape(mb_loc, bm, r_k)
        v3 = v_loc[:, s * bk:(s + 1) * bk].reshape(mb_loc, r_pad, bk)[:, :r_k]
        b_panel = b_loc[(kk % t_b) * bk:(kk % t_b + 1) * bk]
        b_bc = _bcast_panel(b_panel, owner_row, cfg.row_axis, grid,
                            async_op=True)
        if rank_panel_factored_comm(r_k, bm, bk):
            factors = (
                _bcast_panel(u3, owner_col, cfg.col_axis, grid, async_op=True),
                _bcast_panel(v3, owner_col, cfg.col_axis, grid, async_op=True),
            )
            compute = rank_panel_factored_compute(r_k, bm, bk, n_loc)
            issued.append(("factored" if compute else "densify", factors,
                           b_bc))
        else:
            a_panel = (
                _densify(u3, v3, cfg) if col == owner_col else
                torch.empty((m_loc, bk), dtype=u_loc.dtype,
                            device=u_loc.device)
            )
            a_bc = _bcast_panel(a_panel, owner_col, cfg.col_axis, grid,
                                async_op=True)
            issued.append(("dense", (a_bc,), b_bc))
    dense, factored = [], []
    for kind, parts, (b_p, b_work) in issued:
        _wait(b_work, *(work for _, work in parts))
        tensors = [t for t, _ in parts]
        if kind == "factored":
            factored.append((*tensors, b_p))
        elif kind == "densify":
            dense.append((_densify(*tensors, cfg), b_p))
        else:
            dense.append((tensors[0], b_p))
    return _rank_update(dense, factored, m_loc, n_loc, cfg, u_loc.device)


def _exec_ranksparse_pull(u_loc, v_loc, b_loc, plan, *, r_pad: int):
    """One-sided pull of *factorized* A panels (``comm_mode="pull"``).

    Emulates the gets as the reference does: one all-gather per factor
    operand along the grid, then indexed reads of exactly the live
    panels.  The per-panel decisions and the arithmetic are those of
    ``_exec_ranksparse`` term for term (same panels, same order, same
    ``_rank_update``), so pull equals the broadcast rank path bitwise.
    """
    from repro_torch.core.sparsity import (
        rank_panel_factored_comm,
        rank_panel_factored_compute,
    )

    cfg = plan.cfg
    grid = cfg.grid
    bk, m_loc, n_loc, mb_loc, bm, _, _ = _rank_geometry(
        u_loc, v_loc, b_loc, plan, r_pad
    )
    widths = _rank_panel_widths(plan)
    u_full = grid.all_gather(u_loc, cfg.col_axis, dim=1)
    v_full = grid.all_gather(v_loc, cfg.col_axis, dim=1)
    b_full = grid.all_gather(b_loc, cfg.row_axis, dim=0)
    dense, factored = [], []
    for kk in plan.live_panels:
        r_k = min(widths[kk], r_pad)
        u3 = u_full[:, kk * r_pad:kk * r_pad + r_k].reshape(mb_loc, bm, r_k)
        v3 = v_full[:, kk * bk:(kk + 1) * bk].reshape(
            mb_loc, r_pad, bk)[:, :r_k]
        b_panel = b_full[kk * bk:(kk + 1) * bk]
        if rank_panel_factored_comm(r_k, bm, bk) and (
            rank_panel_factored_compute(r_k, bm, bk, n_loc)
        ):
            factored.append((u3, v3, b_panel))
        else:
            dense.append((_densify(u3, v3, cfg), b_panel))
    return _rank_update(dense, factored, m_loc, n_loc, cfg, u_loc.device)


def _exec_ranksparse_grouped(u_loc, v_loc, b_loc, plan, *, r_pad: int):
    """Rank-sparse update through the grouped-GEMM CUDA kernel.

    Broadcasts the live factor panels at full ``r_pad`` width (the kernel
    wants uniform tiles).  Stage 1, every block's ``V @ B_panel``, is the
    grouped GEMM: V rows are the tokens, each ``r_pad``-row tile's expert
    is its panel's B.  Stage 2 applies U per local block row as one
    batched product.  Panels past the comm crossover
    (``rank_panel_factored_comm`` at width ``r_pad``) are densified
    owner-side and run as dense dots, as in the reference.

    Unlike the reference's single launch, stage 1 runs once per chunk of
    local block rows (``RANK_CHUNK_BYTES``), with tokens ordered (block
    row, panel, rank): a chunk's output is then already the
    ``(rows, L·r_pad, n_loc)`` right factor of stage 2, whose left factor
    is the chunk's U panels side by side, and C's rows are written once.
    This reorders the sum over (panel, rank) against the reference, so
    the two agree within the fp32 tolerance, not bitwise.  Where B's
    panels are this rank's own (a grid with one row), the kernel reads
    them in place from ``b_loc`` as ``(t_b, bk, n_loc)`` experts; else
    the broadcast panels are stacked.
    """
    from repro_torch.core.sparsity import rank_panel_factored_comm
    from repro_torch.kernels import ops as kops

    cfg = plan.cfg
    grid = cfg.grid
    acc = cfg.accum_dtype
    bk, m_loc, n_loc, mb_loc, bm, t_a, t_b = _rank_geometry(
        u_loc, v_loc, b_loc, plan, r_pad
    )
    col = grid.axis_index(cfg.col_axis)
    factored_comm = rank_panel_factored_comm(r_pad, bm, bk)
    issued = []
    for kk in plan.live_panels:
        owner_col, owner_row = kk // t_a, kk // t_b
        s = kk % t_a
        u3 = u_loc[:, s * r_pad:(s + 1) * r_pad].reshape(mb_loc, bm, r_pad)
        v3 = v_loc[:, s * bk:(s + 1) * bk].reshape(mb_loc, r_pad, bk)
        b_panel = b_loc[(kk % t_b) * bk:(kk % t_b + 1) * bk]
        b_bc = _bcast_panel(b_panel, owner_row, cfg.row_axis, grid,
                            async_op=True)
        if factored_comm:
            parts = (
                _bcast_panel(u3, owner_col, cfg.col_axis, grid, async_op=True),
                _bcast_panel(v3, owner_col, cfg.col_axis, grid, async_op=True),
            )
        else:
            a_panel = (
                _densify(u3, v3, cfg) if col == owner_col else
                torch.empty((m_loc, bk), dtype=u_loc.dtype,
                            device=u_loc.device)
            )
            parts = (_bcast_panel(a_panel, owner_col, cfg.col_axis, grid,
                                  async_op=True),)
        issued.append((kk, parts, b_bc))
    c = torch.zeros((m_loc, n_loc), dtype=acc, device=u_loc.device)
    panels, u_parts, v_parts, b_parts = [], [], [], []
    for kk, parts, (b_p, b_work) in issued:
        _wait(b_work, *(work for _, work in parts))
        if factored_comm:
            panels.append(kk)
            u_parts.append(parts[0][0])
            v_parts.append(parts[1][0])
            b_parts.append(b_p)
        else:
            _local_dot(parts[0][0], b_p, c, cfg)
    if not panels:
        return c
    live = len(panels)
    if cfg.p_row == 1:  # B's panels are views of b_loc: read them in place
        w = b_loc.reshape(t_b, bk, n_loc)
        experts = np.asarray([kk % t_b for kk in panels], np.int32)
    else:
        w = torch.stack(b_parts)
        experts = np.arange(live, dtype=np.int32)
    del b_parts
    step = _rank_row_chunk(mb_loc, live * r_pad * n_loc * c.element_size())
    tile_expert = np.tile(experts, step)
    for i0 in range(0, mb_loc, step):
        i1 = min(i0 + step, mb_loc)
        rows = i1 - i0
        with span("rank.stage1", device=c.device):
            # tokens ordered (block row, panel, rank): tile (i, l) is panel l
            x = torch.stack([v3[i0:i1] for v3 in v_parts], dim=1)
            y = kops.grouped_gemm(
                x.reshape(rows * live * r_pad, bk), w,
                tile_expert[:rows * live], bt=r_pad, out_dtype=acc,
            )
        with span("rank.stage2", device=c.device):
            u_c = torch.cat([u3[i0:i1] for u3 in u_parts], dim=2).to(acc)
            c[i0 * bm:i1 * bm] += torch.bmm(
                u_c, y.view(rows, live * r_pad, n_loc)
            ).reshape(-1, n_loc)
        del x, y  # the next chunk's buffers are not allocated beside these
    return c


_EXEC_IMPLS = {
    "procedural": _exec_procedural,
    "taskbased": _exec_taskbased,
    "allgather": _exec_allgather,
}


# ---------------------------------------------------------------------------
# The executable cache: plan-digest-keyed programs
# ---------------------------------------------------------------------------

#: (kind, plan digest, local route, window, dtypes[, autotune fingerprint])
#: -> program.  One entry per distinct static execution, process-wide.
_EXEC_CACHE: dict = {}
_EXEC_STATS = {"hits": 0, "misses": 0, "retraces": 0}


def executable_cache_stats() -> dict:
    """Hit/miss/retrace counters and the current size of the executable
    cache.  ``retraces`` counts program builds: with stable keys it equals
    ``misses``, and it can never exceed them."""
    return {**_EXEC_STATS, "size": len(_EXEC_CACHE)}


def clear_executable_cache() -> None:
    """Drop every cached executable and zero the counters (tests)."""
    _EXEC_CACHE.clear()
    for k in _EXEC_STATS:
        _EXEC_STATS[k] = 0


def _autotune_key_suffix() -> tuple:
    """A non-empty kernel autotune cache changes the route ``_local_dot``
    takes, so its fingerprint joins every executable's key; an empty or
    disabled cache adds nothing."""
    fp = cache_fingerprint()
    return (fp,) if fp else ()


def _cached_executable(key: tuple, build: Callable) -> Callable:
    key = key + _autotune_key_suffix()
    fn = _EXEC_CACHE.get(key)
    if fn is None:
        _EXEC_STATS["misses"] += 1
        with span("exec.build"):
            fn = build()
        _EXEC_CACHE[key] = fn
    else:
        _EXEC_STATS["hits"] += 1
    return fn


def _count_build(program):
    _EXEC_STATS["retraces"] += 1
    return program


class _Program:
    """An executable: one plan's interpreter (``_run_plan``, or
    ``_run_rank_plan`` for factor operands) with its plan-derived device
    constants (``_plan_constants``) built once per device.  It holds no
    operand, so a cached program never pins a caller's tensors."""

    def __init__(self, plan, out_dtype, *, factors: bool):
        self.plan, self.out_dtype, self.factors = plan, out_dtype, factors
        self.run = _run_rank_plan if factors else _run_plan
        self.consts: dict = {}

    def __call__(self, *operands):
        a, b = operands[0], operands[-1]
        consts = self.consts.get(b.device)
        if consts is None:
            consts = self.consts[b.device] = _plan_constants(
                self.plan, a.shape, b.shape, b.device, factors=self.factors
            )
        return self.run(*operands, self.plan, self.out_dtype, consts)


def warm_plan_executable(plan, dtype, *, out_dtype=None) -> bool:
    """Build (and cache) the executable for ``plan`` ahead of use, by a
    call on zero operands of this rank's tiles.  Rank-sparse plans need a
    factor payload and are not warmed here (returns ``False``); everything
    else returns ``True``."""
    if plan.local_impl == "ranksparse":
        return False
    (mp, kp), (_, np_) = plan.padded_shapes
    dev = plan.cfg.grid.device
    a = torch.zeros((mp // plan.p_row, kp // plan.p_col), dtype=dtype,
                    device=dev)
    b = torch.zeros((kp // plan.p_row, np_ // plan.p_col), dtype=dtype,
                    device=dev)
    execute_plan(a, b, plan, out_dtype=out_dtype)
    return True


# ---------------------------------------------------------------------------
# Plan execution
# ---------------------------------------------------------------------------


def execute_plan(
    a_loc: torch.Tensor,
    b_loc: torch.Tensor,
    plan,
    *,
    out_dtype: torch.dtype | None = None,
    compiled: bool = True,
) -> torch.Tensor:
    """This rank's tile of C = A @ B under a ``core.plan.MatmulPlan``.

    ``a_loc``/``b_loc`` are this rank's tiles of the operands padded to
    ``plan.padded_shapes`` (``core.api.DistributedMatmul`` cuts them); the
    result is this rank's ``(m_pad/p_row, n_pad/p_col)`` tile of C.  The
    plan's grid must be the world's (``Grid.check_world``): a plan over a
    planning-only grid (``sched.abstract_summa_config``) is refused.
    Dispatches the cached executable of ``(plan digest, dtypes)``;
    ``compiled=False`` runs the same interpreter eagerly.
    """
    _check_plan_operands(a_loc, b_loc, plan)
    plan.cfg.grid.check_world()
    out_dtype = out_dtype or a_loc.dtype
    with span("exec.dispatch", device=b_loc.device):
        if not compiled:
            return _run_plan(a_loc, b_loc, plan, out_dtype, _plan_constants(
                plan, a_loc.shape, b_loc.shape, b_loc.device
            ))
        key = (
            "plan", plan.digest(), plan.local_impl, plan.resolve_lookahead(),
            str(a_loc.dtype), str(b_loc.dtype), str(out_dtype),
        )
        program = _cached_executable(
            key,
            lambda: _count_build(_Program(plan, out_dtype, factors=False)),
        )
        return program(a_loc, b_loc)


@spanned("exec.constants")
def _plan_constants(plan, a_shape, b_shape, device, *,
                    factors: bool = False) -> dict:
    """What an execution of ``plan`` derives from the plan alone, on
    ``device``: the block-mask selectors of this rank's operand tiles (A's,
    or with ``factors`` U's, of ``a_shape``, and B's) and of C, and
    ``bsmm``'s column map of this rank (``walk``, on the host; ``cols``, on
    ``device``), checked and counted once (``columns``, from
    ``kernels.ops.bsmm_columns``), with its count of block products
    (``_bsmm_walk``)."""
    cfg = plan.cfg
    row = cfg.grid.axis_index(cfg.row_axis)
    col = cfg.grid.axis_index(cfg.col_axis)
    (m_loc, k_loc), (kb_loc, n_loc) = a_shape, b_shape
    out = {}
    if factors:  # factors are never masked; an all-live B is not either
        b_masked = plan.b_mask is not None and not plan.b_mask.all()
    else:
        b_masked = plan.a_mask is not None
    if plan.a_mask is not None and not factors:
        out["a"] = _block_keep(
            plan.a_mask, a_shape,
            _block_of(plan.a_mask, plan.m_pad, plan.k_pad),
            (row * m_loc, col * k_loc), device,
        )
    if b_masked:
        out["b"] = _block_keep(
            plan.b_mask, b_shape,
            _block_of(plan.b_mask, plan.k_pad, plan.n_pad),
            (row * kb_loc, col * n_loc), device,
        )
    if plan.c_mask is not None:
        out["c"] = _block_keep(
            plan.c_mask, (m_loc, n_loc),
            _block_of(plan.c_mask, plan.m_pad, plan.n_pad),
            (row * m_loc, col * n_loc), device,
        )
    if plan.local_impl == "bsmm" and not factors:
        from repro_torch.kernels.ops import bsmm_columns

        out["walk"], out["blocks"] = _bsmm_walk(plan, row, col, n_loc)
        out["cols"] = torch.as_tensor(out["walk"], device=device)
        k_blocks = len(plan.live_panels) * plan.kb_width // plan.local_block[1]
        out["columns"] = bsmm_columns(out["walk"], k_blocks, n_loc)
    return out


def _bsmm_walk(plan, row: int, col: int, n_loc: int):
    """``bsmm``'s column map on rank ``(row, col)``, and its count of block
    products: ``(map, (multiplied, useful))``.

    A product is an entry of the rank's map (A's block row ``i``, gathered
    panel ``l``) times one of the kernel's 256-column tiles of the gathered
    B (``TILE_COLS``); it is useful when the ``(kb_width, 256)`` block of B
    it reads meets a live block of ``plan.b_mask``.  Where some is not,
    the map is the intersected one, (mb_loc, tiles, S'): each block row's
    list for each tile keeps the useful entries, so the kernel multiplies
    the useful products alone.  Where every product is useful (no B mask,
    an all-live one, or one whose dead blocks no entry meets), the map is
    the plan's ``local_cols`` entry, one list a block row."""
    from repro_torch.kernels.bsmm import TILE_COLS, tile_lists

    cols = np.asarray(plan.local_cols[row, col], np.int32)
    width = plan.kb_width
    tiles = -(-n_loc // TILE_COLS)
    valid = np.logical_and.accumulate(cols >= 0, axis=-1)
    multiplied = int(valid.sum()) * tiles
    if plan.b_mask is None:
        return cols, (multiplied, multiplied)
    b = np.asarray(plan.b_mask, bool)
    rb, cb = plan.k_pad // b.shape[0], plan.n_pad // b.shape[1]
    # live blocks of B in rows [r0, r1) and columns [c0, c1) of its mask,
    # by the summed-area table
    area = np.zeros((b.shape[0] + 1, b.shape[1] + 1), np.int64)
    area[1:, 1:] = b.cumsum(0).cumsum(1)
    k0 = np.asarray(plan.live_panels) * width
    n0 = col * n_loc + np.arange(tiles) * TILE_COLS
    n1 = np.minimum(n0 + TILE_COLS, (col + 1) * n_loc)
    r0, r1 = (k0 // rb)[:, None], (-(-(k0 + width) // rb))[:, None]
    c0, c1 = n0 // cb, -(-n1 // cb)
    live = (area[r1, c1] - area[r0, c1] - area[r1, c0] + area[r0, c0]) > 0
    useful = int(live[cols[valid]].sum())
    if useful == multiplied:
        return cols, (multiplied, useful)
    walk = tile_lists(cols, live)
    return walk, (int((walk >= 0).sum()), useful)


def _run_plan(a_loc, b_loc, plan, out_dtype, consts) -> torch.Tensor:
    """The plan interpreter (``execute_plan``'s body)."""
    cfg = plan.cfg
    if "a" in consts:
        # Zero masked blocks so padded/garbage data cannot contribute.
        with span("exec.mask", device=a_loc.device, operand="a"):
            a_loc = _apply_block_mask(a_loc, plan.a_mask, keep=consts["a"])
    if "b" in consts:
        with span("exec.mask", device=b_loc.device, operand="b"):
            b_loc = _apply_block_mask(b_loc, plan.b_mask, keep=consts["b"])
    if plan.stationarity != "C":
        c = _exec_stationary(a_loc, b_loc, plan)
    elif plan.local_impl == "bsmm":
        c = _exec_sparse_bsmm(a_loc, b_loc, consts["walk"], plan,
                              cols_dev=consts["cols"],
                              columns=consts["columns"],
                              blocks=consts["blocks"])
    elif plan.local_impl in ("masked", "ranksparse"):
        # Rank plans given dense-stored operands run the masked DAG, as in
        # the reference: without factors there is nothing rank-sized to
        # multiply.  Pull plans run it too (module docstring).
        c = _exec_sparse_dag(a_loc, b_loc, plan)
    else:
        c = _EXEC_IMPLS[cfg.strategy](a_loc, b_loc, plan)
    return _filter_c(c.to(out_dtype), plan, consts)


def _check_plan_operands(a_loc, b_loc, plan) -> None:
    (mp, kp), (_, np_) = plan.padded_shapes
    want_a = (mp // plan.p_row, kp // plan.p_col)
    want_b = (kp // plan.p_row, np_ // plan.p_col)
    if tuple(a_loc.shape) != want_a or tuple(b_loc.shape) != want_b:
        raise ValueError(
            f"local operands {tuple(a_loc.shape)} @ {tuple(b_loc.shape)} do "
            f"not match the plan's tiles {want_a} @ {want_b}"
        )


def rank_operands(a_ranks, plan) -> tuple[np.ndarray, np.ndarray]:
    """Lay a ``RankCSR`` out as the dense-stored factor operands the
    rank-sparse executors consume.

    Returns ``(u_all, v_all)``: ``u_all`` is (m_pad, k_steps·r_pad) with
    block row ``i``, panel ``kk`` holding ``U[i,kk]`` at column offset
    ``kk·r_pad`` (zero beyond the true rank); ``v_all`` is
    (m_blocks·r_pad, k_pad) with ``V[i,kk]`` at row offset ``i·r_pad``,
    column offset ``kk·bk``.  Both are cut into grid tiles exactly like A,
    so every U/V panel lives on the rank that owns the matching A panel.
    Memoized per padded geometry on the (frozen) ``RankCSR``, so repeated
    calls do not lay the factors out again.
    """
    cache_key = ("_rank_operands", plan.m_pad, plan.k_pad, plan.k_steps)
    cached = a_ranks.__dict__.get(cache_key)
    if cached is not None:
        return cached
    with span("rank.layout"):
        bm, bk = a_ranks.bm, a_ranks.bk
        r_pad = a_ranks.r_pad
        csr = a_ranks.csr
        m_blk_p = plan.m_pad // bm
        k_steps = plan.k_steps
        u_all = np.zeros((plan.m_pad, k_steps * r_pad), np.float32)
        v_all = np.zeros((m_blk_p * r_pad, plan.k_pad), np.float32)
        for i in range(csr.m_blocks):
            lo, hi = csr.row_ptr[i], csr.row_ptr[i + 1]
            for s in range(lo, hi):
                kk = int(csr.col_idx[s])
                u_all[i * bm:(i + 1) * bm, kk * r_pad:(kk + 1) * r_pad] = (
                    a_ranks.u[s]
                )
                v_all[i * r_pad:(i + 1) * r_pad, kk * bk:(kk + 1) * bk] = (
                    a_ranks.v[s]
                )
    a_ranks.__dict__[cache_key] = (u_all, v_all)
    return u_all, v_all


def execute_rank_plan(
    u_loc: torch.Tensor,
    v_loc: torch.Tensor,
    b_loc: torch.Tensor,
    plan,
    *,
    out_dtype: torch.dtype | None = None,
    compiled: bool = True,
) -> torch.Tensor:
    """This rank's tile of C = A @ B with A given as factor operands.

    ``u_loc``/``v_loc`` are this rank's tiles of ``rank_operands``'
    arrays and ``b_loc`` its tile of B padded to the plan's (k_pad,
    n_pad), all on one device.  Requires ``plan.local_impl ==
    "ranksparse"`` (the planner guarantees the factor layout fits the
    grid).  ``comm_mode="pull"`` runs ``_exec_ranksparse_pull``; else
    ``local_matmul="pallas"`` runs stage 1 through the grouped-GEMM kernel
    (``_exec_ranksparse_grouped``) and ``"xla"`` through torch products
    (``_exec_ranksparse``).  B is cast to the factors' type first, as
    JAX promotes fp32 factors times a bf16 B; the result has ``out_dtype``
    (default B's dtype).  Dispatches the cached executable of the plan's
    digest and the factor tiles' shapes and dtypes; the factors are
    operands, never part of the executable.  ``compiled=False`` runs
    eagerly.
    """
    _check_rank_operands(u_loc, v_loc, b_loc, plan)
    plan.cfg.grid.check_world()
    out_dtype = out_dtype or b_loc.dtype
    with span("exec.dispatch", device=b_loc.device):
        if not compiled:
            return _run_rank_plan(
                u_loc, v_loc, b_loc, plan, out_dtype,
                _plan_constants(plan, u_loc.shape, b_loc.shape, b_loc.device,
                                factors=True))
        key = (
            "rank", plan.digest(), plan.resolve_lookahead(),
            tuple(u_loc.shape), tuple(v_loc.shape), str(u_loc.dtype),
            str(v_loc.dtype), str(b_loc.dtype), str(out_dtype),
        )
        program = _cached_executable(
            key, lambda: _count_build(_Program(plan, out_dtype, factors=True))
        )
        return program(u_loc, v_loc, b_loc)


def _run_rank_plan(u_loc, v_loc, b_loc, plan, out_dtype, consts):
    """The factorized interpreter (``execute_rank_plan``'s body)."""
    cfg = plan.cfg
    r_pad = u_loc.shape[1] * plan.p_col // plan.k_steps
    # a rank plan carries B's mask even when every block is live; masking
    # then only copies B (4 GiB at N = 32768), so _plan_constants skips it
    if "b" in consts:
        with span("exec.mask", device=b_loc.device, operand="b"):
            b_loc = _apply_block_mask(b_loc, plan.b_mask, keep=consts["b"])
    dtype = torch.promote_types(u_loc.dtype, b_loc.dtype)
    u_loc, v_loc, b_loc = u_loc.to(dtype), v_loc.to(dtype), b_loc.to(dtype)
    if plan.comm_mode == "pull":
        local = _exec_ranksparse_pull
    elif cfg.local_matmul == "pallas":
        local = _exec_ranksparse_grouped
    else:
        local = _exec_ranksparse
    c = local(u_loc, v_loc, b_loc, plan, r_pad=r_pad)
    return _filter_c(c.to(out_dtype), plan, consts)


def _check_rank_operands(u_loc, v_loc, b_loc, plan) -> int:
    """Raise unless the factor tiles fit ``plan``; returns ``r_pad``."""
    if plan.local_impl != "ranksparse":
        raise ValueError(
            f"plan.local_impl={plan.local_impl!r}: not a rank-sparse plan "
            "(factor layout needs M blocks aligned to the grid rows; "
            "densify with RankCSR.to_dense() and use execute_plan)"
        )
    k_r = u_loc.shape[1] * plan.p_col
    if k_r % plan.k_steps:
        raise ValueError(
            f"U width {k_r} must be k_steps={plan.k_steps} factor panels"
        )
    r_pad = k_r // plan.k_steps
    (mp, kp), (_, np_) = plan.padded_shapes
    m_blk_p = plan.a_ranks.shape[0]  # the padded block rows
    want_u = (mp // plan.p_row, k_r // plan.p_col)
    want_v = (m_blk_p * r_pad // plan.p_row, kp // plan.p_col)
    want_b = (kp // plan.p_row, np_ // plan.p_col)
    got = (tuple(u_loc.shape), tuple(v_loc.shape), tuple(b_loc.shape))
    if got != (want_u, want_v, want_b):
        raise ValueError(
            f"factor tiles u{got[0]}/v{got[1]}/b{got[2]} do not match the "
            f"plan's tiles u{want_u}/v{want_v}/b{want_b}"
        )
    return r_pad


def _block_of(mask: np.ndarray, rows: int, cols: int) -> tuple[int, int]:
    return rows // mask.shape[0], cols // mask.shape[1]


def _filter_c(c_loc: torch.Tensor, plan, consts: dict) -> torch.Tensor:
    """Apply the plan's output filter: dead C blocks are zeroed, so an
    execution can never populate blocks the output structure excludes."""
    if "c" not in consts:
        return c_loc
    with span("exec.mask", device=c_loc.device, operand="c"):
        return _apply_block_mask(c_loc, plan.c_mask, keep=consts["c"])


def _block_keep(mask, shape, block, origin, device):
    """The selector of a tile's live elements: the block mask on
    ``device`` and each row's and column's block index, for a tile of
    ``shape`` at ``origin`` of a matrix blocked ``block``."""
    r, c = shape
    rows = torch.arange(origin[0], origin[0] + r, device=device) // block[0]
    cols = torch.arange(origin[1], origin[1] + c, device=device) // block[1]
    return torch.as_tensor(np.asarray(mask, bool), device=device), rows, cols


def _apply_block_mask(
    x: torch.Tensor,
    mask: np.ndarray,
    block: tuple[int, int] | None = None,
    origin: tuple[int, int] = (0, 0),
    *,
    keep=None,
) -> torch.Tensor:
    """Zero the masked blocks of ``x``, a tile at ``origin`` of a matrix
    blocked ``block`` (default: ``x`` is the whole matrix, cut evenly by
    the ``(Rb, Cb)`` mask); ``keep`` is a selector ``_block_keep`` made
    earlier for this tile.  Returns a new tensor."""
    if keep is None:
        r, c = x.shape
        rb, cb = mask.shape
        if block is None:
            if r % rb or c % cb:
                raise ValueError(
                    f"array {tuple(x.shape)} not divisible by mask "
                    f"{mask.shape}"
                )
            block = (r // rb, c // cb)
        keep = _block_keep(mask, x.shape, block, origin, x.device)
    live, rows, cols = keep
    return torch.where(live[rows][:, cols], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Public entry points over global operands (thin plan-and-execute wrappers)
# ---------------------------------------------------------------------------


def local_tile(x: torch.Tensor, cfg: SummaConfig) -> torch.Tensor:
    """This rank's (row, col) tile of a global operand, contiguous on the
    grid's device."""
    g = cfg.grid
    i, j = g.axis_index(cfg.row_axis), g.axis_index(cfg.col_axis)
    r, c = x.shape[0] // cfg.p_row, x.shape[1] // cfg.p_col
    return x[i * r:(i + 1) * r, j * c:(j + 1) * c].to(g.device).contiguous()


def gather_tiles(c_loc: torch.Tensor, cfg: SummaConfig) -> torch.Tensor:
    """The whole matrix from every rank's tile, on every rank."""
    g = cfg.grid
    return g.all_gather(g.all_gather(c_loc, cfg.col_axis, dim=1),
                        cfg.row_axis, dim=0)


def summa_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    cfg: SummaConfig,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Distributed C = A @ B with the configured SUMMA strategy.

    ``a`` (M, K) and ``b`` (K, N) are the global operands on every rank;
    each rank runs its tiles and every rank returns the whole C on the
    grid's device.  Shapes must divide evenly by the grid (use
    ``core.api.DistributedMatmul`` for auto-padding).
    """
    from repro_torch.core.plan import plan_matmul

    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(
            f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    p_row, p_col = cfg.p_row, cfg.p_col
    if m % p_row or n % p_col or k % math.lcm(p_row, p_col):
        raise ValueError(
            f"shapes ({m},{k})x({k2},{n}) must divide grid ({p_row},{p_col})"
        )
    plan = plan_matmul(m, k, n, cfg, itemsize=a.element_size())
    if plan.padded_shapes != ((m, k), (k2, n)):
        raise ValueError(
            f"shapes ({m},{k})x({k2},{n}) need padding for grid/k_blocks; "
            "use core.api.DistributedMatmul for auto-padding"
        )
    return gather_tiles(execute_plan(
        local_tile(a, cfg), local_tile(b, cfg), plan, out_dtype=out_dtype
    ), cfg)


def summa_25d_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    cfg: SummaConfig,
    *,
    rep_axis: str = "pod",
    out_dtype: torch.dtype | None = None,
    plan=None,
) -> torch.Tensor:
    """2.5D task-based SUMMA: operands replicated over ``rep_axis`` (c
    copies), each replica executes a disjoint 1/c of the SUMMA iterations
    (multiple-issue within its range), and the partial C's are summed
    across replicas — Solomonik-Demmel's memory-for-communication trade
    with the paper's task pipeline inside each replica.

    ``a`` and ``b`` are the global operands on every rank; each rank runs
    its (row, col) tiles, the same on every replica, and every rank
    returns the whole C.  Per-replica broadcast traffic drops by c at the
    cost of c× operand memory and one all-reduce of C over ``rep_axis``.
    ``plan`` takes a precomputed (possibly tuned) ``MatmulPlan`` for these
    shapes; by default one is derived here.  The program is cached under
    ``("25d", plan digest, rep_axis, per-replica steps, dtypes)``.
    """
    from repro_torch.core.plan import plan_matmul

    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(
            f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    grid = cfg.grid
    if rep_axis not in grid.shape:
        raise ValueError(
            f"rep_axis {rep_axis!r} is not a mesh axis; "
            f"available: {tuple(grid.shape)}"
        )
    c_rep = grid.shape[rep_axis]
    if plan is None:
        plan = plan_matmul(m, k, n, cfg, itemsize=a.element_size())
    if plan.padded_shapes != ((m, k), (k2, n)):
        raise ValueError(
            f"shapes ({m},{k})x({k2},{n}) need padding for grid/k_blocks"
        )
    k_steps = plan.k_steps
    if k_steps % c_rep:
        raise ValueError(
            f"replica count {c_rep} (mesh axis {rep_axis!r}) must divide "
            f"k_blocks={k_steps} so each replica owns an equal K sub-range"
        )
    per_rep = k_steps // c_rep
    out_dtype = out_dtype or a.dtype
    grid.check_world()

    def build():
        def program(a_loc, b_loc):
            c = _exec_taskbased(
                a_loc, b_loc, plan, k_steps=per_rep,
                k_start=grid.axis_index(rep_axis) * per_rep,
            )
            return grid.all_reduce(c, rep_axis).to(out_dtype)

        return _count_build(program)

    key = ("25d", plan.digest(), rep_axis, per_rep,
           str(a.dtype), str(b.dtype), str(out_dtype))
    program = _cached_executable(key, build)
    return gather_tiles(program(local_tile(a, cfg), local_tile(b, cfg)), cfg)


def summa_blocksparse_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    a_mask: np.ndarray,
    b_mask: np.ndarray,
    cfg: SummaConfig,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Block-sparse distributed C = A @ B over global operands.

    ``a_mask`` (M_blk, K_blk) and ``b_mask`` (K_blk, N_blk) are the static
    block structure; one SUMMA panel per K block.  Globally dead panels
    are skipped; with ``local_matmul="pallas"`` the live ones run through
    the ``bsmm`` kernel on the plan's per-device CSR maps.
    """
    from repro_torch.core.plan import plan_matmul

    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(
            f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    plan = plan_matmul(
        m, k, n, cfg, a_mask=a_mask, b_mask=b_mask,
        itemsize=a.element_size(),
    )
    if plan.padded_shapes != ((m, k), (k2, n)):
        raise ValueError(
            f"shape/grid/blocking mismatch: ({m},{k})x({k2},{n}) on grid "
            f"({cfg.p_row},{cfg.p_col}) with {plan.k_steps} K blocks needs "
            f"padding to {plan.padded_shapes}; use core.api.DistributedMatmul"
        )
    return gather_tiles(execute_plan(
        local_tile(a, cfg), local_tile(b, cfg), plan, out_dtype=out_dtype
    ), cfg)
