"""Materialize a matmul schedule as an explicit fine-grained task DAG.

The port of ``repro.sched.taskgraph`` (numpy over a ``MatmulPlan``; the
same tasks, costs and edges as the reference).  The paper's task
formulation (§3.2) expresses one SUMMA iteration as a small family of
tasks — broadcast the A column-panel, broadcast the B row-panel, run the
rank-k GEMM on every device, accumulate into C — with real dependency
edges between them.  ``core.summa`` runs that formulation as per-rank
programs; this module writes it out *explicitly*, so the schedule can be
simulated, visualised and tuned without ever touching a device.

Two builders:

* :func:`from_plan` — materializes a ``core.plan.MatmulPlan``: one task
  group per live K panel, per-task FLOPs from the plan's per-device
  liveness / BlockCSR column maps (``local_impl="bsmm"``), per-task bytes
  from the same broadcast-as-allreduce model ``plan.PlanCost`` uses.
* :func:`from_tilings` — the paper's nonuniform-block experiment: logical
  blocks are cyclically embedded on a ``p_row x p_col`` grid
  (``core.blocking.cyclic_owner``) and per-task costs follow the actual
  block extents, so per-device load imbalance is visible per iteration.

The multiple-issue lookahead window ``I`` (paper Eq. 1) is encoded as
*dependency edges*: the broadcasts of iteration ``t`` depend on the
accumulate of iteration ``t - I`` on every device of their broadcast
group — at most ``I`` iterations are in flight per device, exactly the
in-flight-iteration cap of the paper's task scheduler.

``BCAST_FACTOR`` also feeds the planner's comm model
(``spgemm.stationarity``), so this module imports nothing of
``core`` at module level.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = [
    "Task",
    "TaskGraph",
    "from_plan",
    "from_tilings",
    "chain_graphs",
    "abstract_summa_config",
    "eq1_lookahead",
]

#: broadcast-as-allreduce moves ~2x the panel bytes of a tree broadcast
#: (same factor as ``core.plan._comm_model``).
BCAST_FACTOR = 2.0


@dataclasses.dataclass(frozen=True)
class Task:
    """One schedulable unit.  Costs are abstract (FLOPs / bytes); the
    simulator converts them to time through a ``MachineModel``."""

    tid: int
    # "bcast_a" | "bcast_b" | "gather_a" | "gather_b" | "fetch_a" |
    # "fetch_b" | "gemm" | "accum"; fetch tasks (one-sided pull) occupy
    # (receiver, owner) so requesters contend on the owner's comm clock
    kind: str
    step: int  # schedule position of the iteration (-1: not per-iteration)
    devices: tuple[int, ...]  # flat device ids whose resource this occupies
    resource: str  # "comm" | "compute"
    flops: float = 0.0
    bytes: float = 0.0


@dataclasses.dataclass
class TaskGraph:
    """An explicit task DAG over a ``p_row x p_col`` device grid.

    ``deps[tid]`` lists the task ids that must finish before ``tid``
    starts.  Tasks are stored in a topological order (builders emit them
    iteration by iteration), which the simulator relies on.
    """

    p_row: int
    p_col: int
    n_steps: int
    lookahead: int
    tasks: list[Task]
    deps: list[tuple[int, ...]]
    meta: dict

    @property
    def n_devices(self) -> int:
        return self.p_row * self.p_col

    def device(self, i: int, j: int) -> int:
        return i * self.p_col + j

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for t in self.tasks:
            out[t.kind] = out.get(t.kind, 0) + 1
        return out

    def total_flops(self) -> float:
        return float(sum(t.flops for t in self.tasks))

    def total_bytes(self) -> float:
        return float(sum(t.bytes for t in self.tasks))

    def validate(self) -> None:
        """Cheap structural invariants (used by tests)."""
        for t, ds in zip(self.tasks, self.deps):
            for d in ds:
                if not 0 <= d < t.tid:
                    raise ValueError(
                        f"task {t.tid} depends on {d}: not topological"
                    )


def abstract_summa_config(p_row: int, p_col: int, **kwargs):
    """A ``SummaConfig`` over a virtual ``p_row x p_col`` grid.

    The grid is a planning-only ``Grid`` (sizes, no process groups, no
    device work), which lets the planner and the simulator study grids far
    larger than the local device count (the paper's
    thousands-of-processes experiments).  Such configs must never reach
    ``execute_plan``, which refuses a grid whose size is not the world's.
    """
    import torch

    from repro_torch.core.grid import Grid
    from repro_torch.core.summa import SummaConfig

    grid = Grid(sizes=(p_row, p_col), device=torch.device("cpu"))
    kwargs.setdefault("row_axis", "data")
    kwargs.setdefault("col_axis", "model")
    return SummaConfig(grid=grid, **kwargs)


# ---------------------------------------------------------------------------
# shared emission machinery
# ---------------------------------------------------------------------------


class _Builder:
    def __init__(self, p_row: int, p_col: int):
        self.p_row = p_row
        self.p_col = p_col
        self.tasks: list[Task] = []
        self.deps: list[tuple[int, ...]] = []

    def dev(self, i: int, j: int) -> int:
        return i * self.p_col + j

    def add(
        self,
        kind: str,
        step: int,
        devices: Iterable[int],
        resource: str,
        deps: Iterable[int] = (),
        flops: float = 0.0,
        bytes: float = 0.0,
    ) -> int:
        tid = len(self.tasks)
        self.tasks.append(
            Task(
                tid=tid, kind=kind, step=step, devices=tuple(devices),
                resource=resource, flops=float(flops), bytes=float(bytes),
            )
        )
        self.deps.append(tuple(deps))
        return tid

    def graph(self, n_steps: int, lookahead: int, meta: dict) -> TaskGraph:
        return TaskGraph(
            p_row=self.p_row, p_col=self.p_col, n_steps=n_steps,
            lookahead=lookahead, tasks=self.tasks, deps=self.deps, meta=meta,
        )


def _emit_pipeline(
    b: _Builder,
    *,
    n_steps: int,
    lookahead: int,
    a_bytes,  # (step, grid_row) -> bytes of the A-panel broadcast (0: skip)
    b_bytes,  # (step, grid_col) -> bytes of the B-panel broadcast (0: skip)
    gemm_flops,  # (step, i, j) -> rank-k update FLOPs (0: dead, no task)
    accum_flops,  # (i, j) -> accumulate FLOPs per iteration
) -> None:
    """Emit the multiple-issue broadcast/gemm/accumulate pipeline.

    Window semantics: iteration ``t``'s broadcasts depend on the
    accumulates of iteration ``t - lookahead`` of every device in the
    broadcast group, capping in-flight iterations per device at
    ``lookahead`` (paper Eq. 1).
    """
    p_row, p_col = b.p_row, b.p_col
    # last accumulate (or gemm) tid per device, per past step
    accum_hist: list[dict[int, int]] = []
    prev_accum: dict[int, int] = {}
    for t in range(n_steps):
        window: dict[int, int] = (
            accum_hist[t - lookahead] if t >= lookahead else {}
        )
        a_tids: dict[int, int] = {}
        for i in range(p_row):
            bytes_ = a_bytes(t, i)
            if bytes_ <= 0:
                continue
            group = [b.dev(i, j) for j in range(p_col)]
            deps = [window[d] for d in group if d in window]
            a_tids[i] = b.add(
                "bcast_a", t, group, "comm", deps=deps, bytes=bytes_
            )
        b_tids: dict[int, int] = {}
        for j in range(p_col):
            bytes_ = b_bytes(t, j)
            if bytes_ <= 0:
                continue
            group = [b.dev(i, j) for i in range(p_row)]
            deps = [window[d] for d in group if d in window]
            b_tids[j] = b.add(
                "bcast_b", t, group, "comm", deps=deps, bytes=bytes_
            )
        step_accum: dict[int, int] = {}
        for i in range(p_row):
            for j in range(p_col):
                d = b.dev(i, j)
                flops = gemm_flops(t, i, j)
                if flops <= 0:
                    # dead iteration for this device: nothing occupies it,
                    # but the window still advances (carry previous task).
                    if d in prev_accum:
                        step_accum[d] = prev_accum[d]
                    continue
                deps = []
                if i in a_tids:
                    deps.append(a_tids[i])
                if j in b_tids:
                    deps.append(b_tids[j])
                if d in prev_accum:
                    deps.append(prev_accum[d])  # C-tile RAW dependency
                g = b.add("gemm", t, (d,), "compute", deps=deps, flops=flops)
                step_accum[d] = b.add(
                    "accum", t, (d,), "compute", deps=(g,),
                    flops=accum_flops(i, j),
                )
        prev_accum = {**prev_accum, **step_accum}
        accum_hist.append(dict(prev_accum))


def _emit_pull_pipeline(
    b: _Builder,
    *,
    n_steps: int,
    lookahead: int,
    owner_col,  # (step,) -> grid column owning the A panel
    owner_row,  # (step,) -> grid row owning the B panel
    a_fetch_bytes,  # (step, grid_row) -> bytes of one A-panel fetch
    b_fetch_bytes,  # (step, grid_col) -> bytes of one B-panel fetch
    gemm_flops,  # (step, i, j) -> rank-k update FLOPs (0: dead, no task)
    accum_flops,  # (i, j) -> accumulate FLOPs per iteration
) -> None:
    """The one-sided variant of :func:`_emit_pipeline` (RDMA-SpGEMM).

    No broadcast trees: each *surviving* gemm pulls exactly the panels it
    reads straight from their owners, at factor-1.0 bytes (a get moves
    the payload once).  A fetch occupies both endpoints — receiver and
    owner — on the comm resource, so many requesters of one hot panel
    serialize on the owner's clock; that contention, against broadcast's
    2x-bytes-but-parallel trees, is the crossover the simulator resolves.
    Dead gemms fetch nothing, which is where pull wins as fill drops.
    Window semantics match :func:`_emit_pipeline` (paper Eq. 1).
    """
    p_row, p_col = b.p_row, b.p_col
    accum_hist: list[dict[int, int]] = []
    prev_accum: dict[int, int] = {}
    for t in range(n_steps):
        window: dict[int, int] = (
            accum_hist[t - lookahead] if t >= lookahead else {}
        )
        oc, orow = owner_col(t), owner_row(t)
        step_accum: dict[int, int] = {}
        for i in range(p_row):
            for j in range(p_col):
                d = b.dev(i, j)
                flops = gemm_flops(t, i, j)
                if flops <= 0:
                    # dead iteration: no fetch, no gemm; the window still
                    # advances (carry previous task).
                    if d in prev_accum:
                        step_accum[d] = prev_accum[d]
                    continue
                deps = []
                if p_col > 1 and j != oc:
                    owner = b.dev(i, oc)
                    bytes_ = a_fetch_bytes(t, i)
                    if bytes_ > 0:
                        fdeps = [
                            window[x] for x in sorted({d, owner})
                            if x in window
                        ]
                        deps.append(b.add(
                            "fetch_a", t, (d, owner), "comm", deps=fdeps,
                            bytes=bytes_,
                        ))
                if p_row > 1 and i != orow:
                    owner = b.dev(orow, j)
                    bytes_ = b_fetch_bytes(t, j)
                    if bytes_ > 0:
                        fdeps = [
                            window[x] for x in sorted({d, owner})
                            if x in window
                        ]
                        deps.append(b.add(
                            "fetch_b", t, (d, owner), "comm", deps=fdeps,
                            bytes=bytes_,
                        ))
                if d in prev_accum:
                    deps.append(prev_accum[d])  # C-tile RAW dependency
                g = b.add("gemm", t, (d,), "compute", deps=deps, flops=flops)
                step_accum[d] = b.add(
                    "accum", t, (d,), "compute", deps=(g,),
                    flops=accum_flops(i, j),
                )
        prev_accum = {**prev_accum, **step_accum}
        accum_hist.append(dict(prev_accum))


def _emit_stationary(b: _Builder, plan) -> None:
    """The A-/B-stationary schedule as an explicit DAG (repro.spgemm).

    Mirrors ``summa.execute_plan``'s stationary route exactly:
    one re-layout of the *moving* operand (modeled broadcast-as-allreduce
    along the grid axis the stationarity chooser charges), one dense
    local dot per device — the executors prune structure at the value
    level only, so the honest FLOP charge is the full local product —
    and one bandwidth-optimal reduce-scatter of the partial C tiles per
    scatter group, factor ``(g-1)/g``.  No K pipeline, so no
    multiple-issue window.
    """
    p_row, p_col = b.p_row, b.p_col
    itemsize = plan.itemsize
    m_loc = plan.m_pad // p_row
    n_loc = plan.n_pad // p_col
    accum = float(m_loc * n_loc)

    def _kshard_elems(density: np.ndarray, n_groups: int) -> np.ndarray:
        """Split a per-K-element live-element density into the ``n_groups``
        contiguous K shards the re-layout distributes (total preserved even
        when shards straddle block boundaries)."""
        if density.size % n_groups == 0:
            return density.reshape(n_groups, -1).sum(axis=1)
        return np.full(n_groups, density.sum() / n_groups)

    if plan.stationarity == "A":
        # B re-lays out to P(col_axis, None): the grid-column group j
        # receives B's K-shard j (all N columns), then partial C tiles
        # reduce-scatter along the columns of each grid row.
        b_mask = getattr(plan, "b_mask", None)
        if b_mask is not None:
            kb_sz = plan.k_pad // b_mask.shape[0]
            bn_sz = plan.n_pad // b_mask.shape[1]
            dens = np.repeat(
                b_mask.sum(axis=1).astype(np.float64) * bn_sz, kb_sz
            )
        else:
            dens = np.full(plan.k_pad, float(plan.n_pad))
        shard_elems = _kshard_elems(dens, p_col)
        relay: dict[int, int] = {}
        if p_row > 1:  # same gate as the chooser's BCAST·vol_b·row term
            for j in range(p_col):
                bytes_ = BCAST_FACTOR * float(shard_elems[j]) * itemsize
                if bytes_ <= 0:
                    continue
                group = [b.dev(i, j) for i in range(p_row)]
                relay[j] = b.add(
                    "bcast_b", 0, group, "comm", bytes=bytes_
                )
        gemm_flops = 2.0 * m_loc * (plan.k_pad // max(p_col, 1)) * plan.n_pad
        scatter_bytes = (
            (p_col - 1) / p_col * m_loc * plan.n_pad * itemsize
            if p_col > 1 else 0.0
        )
        gemms: dict[tuple[int, int], int] = {}
        for i in range(p_row):
            for j in range(p_col):
                deps = [relay[j]] if j in relay else []
                gemms[i, j] = b.add(
                    "gemm", 0, (b.dev(i, j),), "compute", deps=deps,
                    flops=gemm_flops,
                )
        for i in range(p_row):
            group = [b.dev(i, j) for j in range(p_col)]
            deps = [gemms[i, j] for j in range(p_col)]
            rid = (
                b.add("reduce", 0, group, "comm", deps=deps,
                      bytes=scatter_bytes)
                if scatter_bytes > 0 else None
            )
            for j in range(p_col):
                b.add(
                    "accum", 0, (b.dev(i, j),), "compute",
                    deps=(rid,) if rid is not None else (gemms[i, j],),
                    flops=accum,
                )
    else:  # "B": A re-lays out to P(None, row_axis), scatter along rows
        a_mask = getattr(plan, "a_mask", None)
        if a_mask is not None:
            bm_sz = plan.m_pad // a_mask.shape[0]
            ka_sz = plan.k_pad // a_mask.shape[1]
            dens = np.repeat(
                a_mask.sum(axis=0).astype(np.float64) * bm_sz, ka_sz
            )
        else:
            dens = np.full(plan.k_pad, float(plan.m_pad))
        shard_elems = _kshard_elems(dens, p_row)
        relay = {}
        if p_col > 1:  # same gate as the chooser's BCAST·vol_a·col term
            for i in range(p_row):
                bytes_ = BCAST_FACTOR * float(shard_elems[i]) * itemsize
                if bytes_ <= 0:
                    continue
                group = [b.dev(i, j) for j in range(p_col)]
                relay[i] = b.add(
                    "bcast_a", 0, group, "comm", bytes=bytes_
                )
        gemm_flops = 2.0 * plan.m_pad * (plan.k_pad // max(p_row, 1)) * n_loc
        scatter_bytes = (
            (p_row - 1) / p_row * plan.m_pad * n_loc * itemsize
            if p_row > 1 else 0.0
        )
        gemms = {}
        for i in range(p_row):
            for j in range(p_col):
                deps = [relay[i]] if i in relay else []
                gemms[i, j] = b.add(
                    "gemm", 0, (b.dev(i, j),), "compute", deps=deps,
                    flops=gemm_flops,
                )
        for j in range(p_col):
            group = [b.dev(i, j) for i in range(p_row)]
            deps = [gemms[i, j] for i in range(p_row)]
            rid = (
                b.add("reduce", 0, group, "comm", deps=deps,
                      bytes=scatter_bytes)
                if scatter_bytes > 0 else None
            )
            for i in range(p_row):
                b.add(
                    "accum", 0, (b.dev(i, j),), "compute",
                    deps=(rid,) if rid is not None else (gemms[i, j],),
                    flops=accum,
                )


# ---------------------------------------------------------------------------
# builder 1: from a MatmulPlan
# ---------------------------------------------------------------------------


def _bsmm_step_flops(plan) -> np.ndarray:
    """(p_row, p_col, L) executed FLOPs per live-panel position from the
    plan's per-device BlockCSR column maps (``local_impl="bsmm"``)."""
    cols = plan.local_cols  # (p_row, p_col, mb_loc, S), -1 pad
    live = len(plan.live_panels)
    bm, bk, _ = plan.local_block
    n_loc = plan.n_pad // plan.p_col
    # count of local row blocks touching each gathered panel position
    cnt = (cols[..., None] == np.arange(live)).any(axis=3).sum(axis=2)
    return cnt.astype(np.float64) * (2.0 * bm * bk * n_loc)


def _rank_step_flops(plan) -> np.ndarray:
    """(p_row, p_col, L) executed FLOPs per live-panel position from the
    plan's per-block ranks (``local_impl="ranksparse"``).

    Device (i, j) charges, for each of its local block rows, the factored
    block cost of that row's rank in the panel (``block_rank_flops`` — the
    same per-block ordering-by-flop-count the executor applies), gated on
    the panel being live for the device at all.  This is where rank
    *nonuniformity* becomes per-device load imbalance the simulator and
    tuner can see.
    """
    from repro_torch.core.sparsity import block_rank_flops

    p_row, p_col = plan.p_row, plan.p_col
    ranks = plan.a_ranks  # (M_blk, K_blk) padded
    m_blk = ranks.shape[0]
    mb_loc = m_blk // p_row
    bm = plan.m_pad // m_blk
    bk = plan.kb_width
    n_loc = plan.n_pad // p_col
    live = list(plan.live_panels)
    out = np.zeros((p_row, p_col, len(live)))
    for i in range(p_row):
        rows = ranks[i * mb_loc : (i + 1) * mb_loc, :]
        for t, kk in enumerate(live):
            flops = sum(
                block_rank_flops(int(r), bm, bk, n_loc) for r in rows[:, kk]
            )
            for j in range(p_col):
                if plan.device_live is None or plan.device_live[i, j, kk]:
                    out[i, j, t] = flops
    return out


def from_plan(
    plan,
    *,
    strategy: str | None = None,
    lookahead: int | None = None,
) -> TaskGraph:
    """Materialize a ``MatmulPlan`` into the explicit task DAG it implies.

    ``strategy`` defaults to the plan's own: the broadcast pipeline for
    ``procedural`` (window forced to 1) / ``taskbased`` (window = the
    plan's resolved lookahead), or the bulk-gather graph for
    ``allgather``.  Masked plans always build the pipeline over their
    *live* panels, with per-device FLOPs from the BlockCSR maps when the
    plan runs the BSMM kernel.
    """
    p_row, p_col = plan.p_row, plan.p_col
    itemsize = plan.itemsize
    m_loc = plan.m_pad // p_row
    n_loc = plan.n_pad // p_col
    kb = plan.kb_width
    steps = list(plan.live_panels)
    n_steps = len(steps)
    strategy = strategy or (
        plan.cfg.strategy if plan.local_impl == "dense" else "taskbased"
    )
    b = _Builder(p_row, p_col)
    # Grid column owning each emitted iteration's A panel (contiguous
    # panel schedule, same arithmetic as summa._panel_slices) — the chain
    # builder uses this to wire C(step i) -> bcast_a(step i+1) edges.
    t_a = max(plan.k_steps // p_col, 1)
    meta = {
        "source": "plan",
        "strategy": strategy,
        "shape": [plan.m, plan.k, plan.n],
        "grid": [p_row, p_col],
        "local_impl": plan.local_impl,
        "comm_mode": getattr(plan, "comm_mode", "broadcast"),
        "a_owner": [int(kk // t_a) for kk in steps],
    }

    if getattr(plan, "stationarity", "C") != "C":
        # A-/B-stationary schedules have no K pipeline: one re-layout of
        # the moving operand, one local dot per device, one reduce-scatter
        # per group (satellite of repro.spgemm — the chooser can pick
        # these, so the DAG layer must materialize them too).
        meta["strategy"] = "stationary"
        meta["stationarity"] = plan.stationarity
        meta["lookahead"] = 1
        _emit_stationary(b, plan)
        graph = b.graph(1, 1, meta)
        graph.validate()
        return graph

    if strategy == "allgather":
        if plan.local_impl != "dense":
            raise ValueError("allgather graph is dense-only (sparsity-blind)")
        ga: dict[int, int] = {}
        gb: dict[int, int] = {}
        if p_col > 1:
            bytes_a = itemsize * m_loc * plan.k_pad * (p_col - 1) / p_col
            for i in range(p_row):
                ga[i] = b.add(
                    "gather_a", -1, [b.dev(i, j) for j in range(p_col)],
                    "comm", bytes=bytes_a,
                )
        if p_row > 1:
            bytes_b = itemsize * plan.k_pad * n_loc * (p_row - 1) / p_row
            for j in range(p_col):
                gb[j] = b.add(
                    "gather_b", -1, [b.dev(i, j) for i in range(p_row)],
                    "comm", bytes=bytes_b,
                )
        flops = 2.0 * m_loc * plan.k_pad * n_loc
        for i in range(p_row):
            for j in range(p_col):
                deps = [t for t in (ga.get(i), gb.get(j)) if t is not None]
                g = b.add(
                    "gemm", 0, (b.dev(i, j),), "compute", deps=deps,
                    flops=flops,
                )
                b.add(
                    "accum", 0, (b.dev(i, j),), "compute", deps=(g,),
                    flops=float(m_loc * n_loc),
                )
        graph = b.graph(1, n_steps or 1, meta)
        graph.meta["lookahead"] = graph.lookahead
        return graph

    from repro_torch.core.summa import resolve_multi_issue

    if strategy == "procedural":
        window = 1
    else:
        window = lookahead if lookahead is not None else plan.resolve_lookahead()
    # re-clamp: masked plans schedule only their live panels
    window = resolve_multi_issue(p_row, p_col, n_steps, window)
    meta["lookahead"] = window

    if plan.local_impl == "bsmm":
        step_flops = _bsmm_step_flops(plan)  # (p_row, p_col, L)

        def gemm_flops(t, i, j):
            return float(step_flops[i, j, t])
    elif plan.local_impl == "ranksparse":
        step_flops = _rank_step_flops(plan)  # (p_row, p_col, L)

        def gemm_flops(t, i, j):
            return float(step_flops[i, j, t])
    elif plan.local_impl == "masked" and plan.device_live is not None:
        # Output-structure-aware pruning (repro.spgemm): a gemm whose C
        # tile is dead for this panel — no surviving (a, b, c) block
        # triple on the device — is never emitted.
        dense_panel = 2.0 * m_loc * kb * n_loc

        def gemm_flops(t, i, j):
            return dense_panel if plan.device_live[i, j, steps[t]] else 0.0
    else:
        # dense: every device executes every panel
        dense_panel = 2.0 * m_loc * kb * n_loc

        def gemm_flops(t, i, j):
            return dense_panel

    # B-panel bytes from *surviving* blocks (mirroring the A side): a
    # mostly-dead panel column broadcasts only its live blocks.
    b_live = None
    if p_row > 1 and getattr(plan, "b_mask", None) is not None:
        from repro_torch.core.plan import b_panel_live_elems

        bn_sz = plan.n_pad // plan.b_mask.shape[1]
        b_live = b_panel_live_elems(
            plan.b_mask, getattr(plan, "b_ranks", None),
            bk_sz=kb, bn_sz=bn_sz, p_col=p_col,
        )

    if getattr(plan, "comm_mode", "broadcast") == "pull":
        if plan.local_impl == "masked":
            if plan.device_live is None:
                raise ValueError("pull graphs need per-device liveness")
        elif plan.local_impl != "ranksparse":
            raise ValueError("pull graphs need a masked or rank-sparse plan")
        if plan.local_impl == "ranksparse":
            # A fetches move factor panels while they beat the dense
            # panel: m_loc·r_k U rows plus mb_loc·r_k·kb V rows, the same
            # per-panel crossover ``core.plan._pull_comm_bytes`` charges
            # and ``summa._exec_ranksparse_pull`` slices.
            from repro_torch.core.sparsity import rank_panel_factored_comm

            mb_loc_r = plan.a_ranks.shape[0] // p_row
            bm_sz_r = plan.m_pad // plan.a_ranks.shape[0]
            r_live = plan.a_ranks.max(axis=0)

            def a_fetch_bytes(t, i):
                r_k = max(int(r_live[steps[t]]), 1)
                elems = (
                    m_loc * r_k + mb_loc_r * r_k * kb
                    if rank_panel_factored_comm(r_k, bm_sz_r, kb)
                    else m_loc * kb
                )
                return float(elems) * itemsize
        else:

            def a_fetch_bytes(t, i):
                return float(m_loc * kb * itemsize)

        t_b = max(plan.k_steps // p_row, 1)
        meta["b_owner"] = [int(kk // t_b) for kk in steps]
        _emit_pull_pipeline(
            b,
            n_steps=n_steps,
            lookahead=window,
            owner_col=lambda t: int(steps[t] // t_a),
            owner_row=lambda t: int(steps[t] // t_b),
            a_fetch_bytes=a_fetch_bytes,
            b_fetch_bytes=lambda t, j: (
                float(b_live[steps[t], j]) * itemsize
                if b_live is not None
                else float(kb * n_loc * itemsize)
            ),
            gemm_flops=gemm_flops,
            accum_flops=lambda i, j: float(m_loc * n_loc),
        )
        return b.graph(n_steps, window, meta)

    a_panel_bytes = BCAST_FACTOR * m_loc * kb * itemsize if p_col > 1 else 0.0
    b_panel_bytes = BCAST_FACTOR * kb * n_loc * itemsize if p_row > 1 else 0.0
    if plan.local_impl == "ranksparse" and p_col > 1:
        # Factor panels travel instead of dense A panels: a (m_loc, r_k)
        # U panel plus (mb_loc, r_k, bk) V rows, r_k the panel max rank —
        # unless the panel is past the comm crossover r* = bm·bk/(bm+bk),
        # where it is reconstructed owner-side and dense bytes travel.
        # Same per-panel decision as core.plan / the executor.
        from repro_torch.core.sparsity import rank_panel_factored_comm

        mb_loc = plan.a_ranks.shape[0] // p_row
        bm_sz = plan.m_pad // plan.a_ranks.shape[0]
        r_live = plan.a_ranks.max(axis=0)

        def a_bytes(t, i):
            r_k = max(int(r_live[steps[t]]), 1)
            elems = (
                m_loc * r_k + mb_loc * r_k * kb
                if rank_panel_factored_comm(r_k, bm_sz, kb)
                else m_loc * kb
            )
            return BCAST_FACTOR * elems * itemsize
    else:

        def a_bytes(t, i):
            return a_panel_bytes

    if b_live is not None:

        def b_bytes(t, j):
            return BCAST_FACTOR * float(b_live[steps[t], j]) * itemsize
    else:

        def b_bytes(t, j):
            return b_panel_bytes

    _emit_pipeline(
        b,
        n_steps=n_steps,
        lookahead=window,
        a_bytes=a_bytes,
        b_bytes=b_bytes,
        gemm_flops=gemm_flops,
        accum_flops=lambda i, j: float(m_loc * n_loc),
    )
    return b.graph(n_steps, window, meta)


# ---------------------------------------------------------------------------
# builder 2: from nonuniform tilings (the paper's §4 experiment)
# ---------------------------------------------------------------------------


def from_tilings(
    p_row: int,
    p_col: int,
    row_tiling,
    inner_tiling,
    col_tiling,
    *,
    lookahead: int | None = None,
    itemsize: int = 4,
) -> TaskGraph:
    """Fine-grained task DAG for a (possibly nonuniform) blocked matmul.

    One SUMMA iteration per inner (K) logical block; its panel width is
    that block's extent, so per-iteration costs are nonuniform exactly as
    in the paper.  Row / column blocks embed cyclically on the grid
    (``cyclic_owner``), giving each device its own M x N footprint — the
    per-device load imbalance that multiple-issue must absorb.

    ``lookahead=None`` resolves paper Eq. (1).
    """
    from repro_torch.core.summa import resolve_multi_issue

    rows = np.asarray(row_tiling.sizes, dtype=np.int64)
    inner = np.asarray(inner_tiling.sizes, dtype=np.int64)
    cols = np.asarray(col_tiling.sizes, dtype=np.int64)
    n_steps = len(inner)
    # cyclic embedding: block b of the row blocking lives on grid row b%p
    rows_per = np.zeros(p_row, dtype=np.int64)
    np.add.at(rows_per, np.arange(len(rows)) % p_row, rows)
    cols_per = np.zeros(p_col, dtype=np.int64)
    np.add.at(cols_per, np.arange(len(cols)) % p_col, cols)
    window = resolve_multi_issue(p_row, p_col, n_steps, lookahead)

    b = _Builder(p_row, p_col)
    _emit_pipeline(
        b,
        n_steps=n_steps,
        lookahead=window,
        a_bytes=lambda t, i: (
            BCAST_FACTOR * float(rows_per[i] * inner[t]) * itemsize
            if p_col > 1 else 0.0
        ),
        b_bytes=lambda t, j: (
            BCAST_FACTOR * float(inner[t] * cols_per[j]) * itemsize
            if p_row > 1 else 0.0
        ),
        gemm_flops=lambda t, i, j: 2.0 * float(
            rows_per[i] * inner[t] * cols_per[j]
        ),
        accum_flops=lambda i, j: float(rows_per[i] * cols_per[j]),
    )
    imbalance = float(
        (rows_per.max() * cols_per.max()) / max(rows_per.min() * cols_per.min(), 1)
    )
    return b.graph(
        n_steps,
        window,
        {
            "source": "tilings",
            "strategy": "taskbased" if window > 1 else "procedural",
            "shape": [int(rows.sum()), int(inner.sum()), int(cols.sum())],
            "grid": [p_row, p_col],
            "lookahead": window,
            # cyclic embedding: inner block t's A panel lives on column t%p
            "a_owner": [t % p_col for t in range(n_steps)],
            "static_imbalance": imbalance,
            "uniform": bool(
                row_tiling.is_uniform
                and inner_tiling.is_uniform
                and col_tiling.is_uniform
            ),
        },
    )


# ---------------------------------------------------------------------------
# builder 3: the union graph of chained multiplications
# ---------------------------------------------------------------------------


def chain_graphs(graphs: list[TaskGraph]) -> TaskGraph:
    """Union task DAG of consecutive multiplications ``C_i = C_{i-1} @ B_i``.

    The paper's observation that "no explicit internodal synchronization
    lets multiple MMs overlap" realised as edges: instead of a global
    barrier between steps, the C tile each A-panel broadcast of step
    ``i+1`` *reads* gates only that broadcast — the dependency is the
    final ``accum`` of the owning device (grid row of the broadcast
    group x the panel's owner column, ``meta["a_owner"]``).  B-side
    broadcasts of step ``i+1`` touch fresh operands and carry no
    cross-step edges at all, so they (and early A panels) overlap the
    tail of step ``i``.

    On a single-column grid A panels need no broadcast (the local C rows
    *are* the next operand): the first ``gemm`` per device takes the
    cross edge instead.  ``gather_a`` tasks (allgather strategy) read the
    whole row of C shards and depend on every accum in their group.

    The simulated makespan of the union graph is never worse than the
    sum of the per-step makespans: resource-free times and cross-step
    dependency finishes after step ``i`` are bounded by step ``i``'s
    barrier-synchronized finish, inductively.
    """
    if not graphs:
        raise ValueError("chain_graphs needs at least one graph")
    p_row, p_col = graphs[0].p_row, graphs[0].p_col
    for g in graphs[1:]:
        if (g.p_row, g.p_col) != (p_row, p_col):
            raise ValueError(
                "all chained graphs must share one device grid; got "
                f"{(p_row, p_col)} and {(g.p_row, g.p_col)}"
            )
    b = _Builder(p_row, p_col)
    last_accum: dict[int, int] = {}  # device -> last accum tid so far
    for s, g in enumerate(graphs):
        offset = len(b.tasks)
        a_owner = g.meta.get("a_owner")
        cur_accum: dict[int, int] = {}
        linked_gemm: set[int] = set()
        for task, deps in zip(g.tasks, g.deps):
            new_deps = [d + offset for d in deps]
            if s > 0:
                if task.kind in ("bcast_a", "fetch_a"):
                    # fetch_a: the receiver is devices[0]; its pulled A
                    # panel reads the prior step's C exactly like a
                    # broadcast root would.
                    if a_owner is None:
                        raise ValueError(
                            "chained graph lacks meta['a_owner'] for its "
                            "A-panel broadcasts"
                        )
                    row = task.devices[0] // p_col
                    owner_dev = row * p_col + int(a_owner[task.step])
                    if owner_dev in last_accum:
                        new_deps.append(last_accum[owner_dev])
                elif task.kind == "gather_a":
                    new_deps.extend(
                        last_accum[d] for d in task.devices
                        if d in last_accum
                    )
                elif task.kind == "gemm" and p_col == 1:
                    d = task.devices[0]
                    if d not in linked_gemm and d in last_accum:
                        new_deps.append(last_accum[d])
                        linked_gemm.add(d)
            tid = b.add(
                task.kind, task.step, task.devices, task.resource,
                deps=new_deps, flops=task.flops, bytes=task.bytes,
            )
            if task.kind == "accum":
                for d in task.devices:
                    cur_accum[d] = tid
        last_accum = {**last_accum, **cur_accum}
    graph = b.graph(
        sum(g.n_steps for g in graphs),
        max(g.lookahead for g in graphs),
        {
            "source": "chain",
            "strategy": "taskbased",
            "grid": [p_row, p_col],
            "n_chain_steps": len(graphs),
            "lookahead": [int(g.lookahead) for g in graphs],
            "per_step": [dict(g.meta) for g in graphs],
            "shape": [list(g.meta.get("shape", [])) for g in graphs],
        },
    )
    graph.validate()
    return graph


def eq1_lookahead(p_row: int, p_col: int, k_steps: int) -> int:
    """Paper Eq. (1) clamped to the schedule length (convenience)."""
    from repro_torch.core.summa import resolve_multi_issue

    return resolve_multi_issue(p_row, p_col, k_steps)
