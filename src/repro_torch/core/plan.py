"""MatmulPlan: one sparsity-aware execution plan for every matmul path.

The paper's central claim is that a single task formulation absorbs
dense, block-sparse, and nonuniformly blocked matrices without separate
algorithms.  ``MatmulPlan`` is that formulation made static: given
operand shapes, optional block masks, and a ``SummaConfig`` it
precomputes — once, in numpy, outside any trace —

* padded, grid- and block-aligned physical shapes;
* the K-panel schedule (panel width, owners, over-decomposition);
* **global panel liveness** (panels dead for every device: neither their
  broadcast nor their rank-k update is emitted — today's trace-time
  pruning) and **per-device panel liveness** (panels dead *for that grid
  row/column*, strictly finer on structured masks);
* per-device ``BlockCSR`` column maps feeding the CUDA block-sparse
  BSMM kernel, so surviving panels still skip dead blocks locally;
* a cost model (modeled per-device collective bytes for every strategy,
  dense/sparse FLOPs, fill-in) that upper layers use to pick a strategy.

``core.summa.execute_plan`` interprets a plan as one rank's program on
a ``Grid``; ``core.api.DistributedMatmul`` is the thin front-end that
builds (and caches) plans.

The port of ``repro.core.plan``: every field of a plan equals the
reference's for the same inputs (the tests hold them equal), except
``digest()``, which hashes the grid's fingerprint where the reference
hashes the mesh's devices.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from repro_torch.analysis.spans import spanned
from repro_torch.core.sparsity import BlockRankMap, mask_matmul_flops
from repro_torch.core.summa import SummaConfig, resolve_multi_issue

__all__ = ["MatmulPlan", "PlanCost", "plan_matmul", "mask_key", "rank_key"]


def _ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def mask_key(mask: np.ndarray | None) -> tuple | None:
    """Stable, cheap cache key for a block mask (shape + content digest)."""
    if mask is None:
        return None
    mask = np.asarray(mask, dtype=bool)
    return (mask.shape, hashlib.sha1(mask.tobytes()).hexdigest())


def rank_key(ranks) -> tuple | None:
    """Stable cache key for a rank structure (``BlockRankMap`` or
    ``RankCSR``): block grid + extents + per-block-rank content digest.
    Factor *values* are intentionally not keyed — the plan depends only on
    the static structure (``DistributedMatmul`` documents this)."""
    if ranks is None:
        return None
    rank_map = ranks.rank_map() if hasattr(ranks, "rank_map") else ranks
    arr = np.ascontiguousarray(rank_map.ranks, dtype=np.int32)
    return (
        arr.shape,
        rank_map.bm,
        rank_map.bk,
        hashlib.sha1(arr.tobytes()).hexdigest(),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class PlanCost:
    """Static cost estimates attached to a plan (modeled, per device)."""

    flops_dense: float  # global useful FLOPs of the dense product
    flops_sparse: float  # global FLOPs given masks AND ranks (== dense if none)
    comm_bytes: dict  # strategy -> modeled per-device collective bytes
    fill_in: float  # flops_sparse / flops_dense
    # Mask-only accounting of the same structure (every live block charged
    # its dense area).  Equals ``flops_sparse`` unless the plan carries
    # per-block ranks, where the gap is exactly what rank-sparsity buys.
    flops_mask: float | None = None

    def best_strategy(self, candidates: tuple[str, ...]) -> str:
        known = [c for c in candidates if c in self.comm_bytes]
        if not known:
            raise ValueError(f"no known strategy among {candidates}")
        return min(known, key=lambda c: self.comm_bytes[c])


@dataclasses.dataclass(frozen=True, eq=False)
class MatmulPlan:
    """The full static schedule of one distributed (block-sparse) matmul.

    All index math is resolved here; the executors in ``core.summa`` only
    interpret it.  ``local_impl`` selects the local rank-k realisation:

    * ``"dense"``  — no masks; strategy pipelines run dense panel dots.
    * ``"masked"`` — masks present; globally-live panels run as a task
      DAG with masked operands (the fallback when the BSMM alignment
      conditions fail).
    * ``"bsmm"``   — masks present and ``local_matmul="pallas"``: live
      panels are gathered once, then the CUDA block-sparse kernel
      consumes this device's CSR column map — local FLOPs scale with the
      *per-device* fill-in, not the global one.
    """

    cfg: SummaConfig
    m: int
    k: int
    n: int
    m_pad: int
    k_pad: int
    n_pad: int
    k_steps: int
    kb_width: int
    live_panels: tuple[int, ...]
    a_mask: np.ndarray | None  # padded (M_blk, K_blk) block mask
    b_mask: np.ndarray | None  # padded (K_blk, N_blk) block mask
    device_live: np.ndarray | None  # (p_row, p_col, k_steps) bool
    local_cols: np.ndarray | None  # (p_row, p_col, mb_loc, S) int32, -1 pad
    local_block: tuple[int, int, int] | None  # (bm, bk, bn) for the kernel
    local_impl: str  # "dense" | "masked" | "bsmm" | "ranksparse"
    cost: PlanCost
    itemsize: int
    # Padded (M_blk, K_blk) int32 per-block ranks of A (block-rank
    # sparsity); None unless planned with ``a_ranks=``.  ``a_mask`` is then
    # ``a_ranks > 0`` and ``local_impl == "ranksparse"`` when the factor
    # layout fits the grid (``execute_rank_plan`` consumes the factors;
    # dense-stored execution of the same plan runs the masked DAG).
    a_ranks: np.ndarray | None = None
    # Per-plan multiple-issue window (paper Eq. 1).  ``None`` defers to
    # ``cfg.resolve_lookahead``; the schedule autotuner (repro.sched.tuner)
    # sets it, and ``core.summa._exec_taskbased`` honors it.
    lookahead: int | None = None
    # Search record attached by ``repro.sched.tuner.tune_plan`` (winning
    # strategy/k_blocks/lookahead, simulated makespan, static baseline).
    tuned: dict | None = None
    # -- SpGEMM extensions (repro.spgemm) ------------------------------------
    # Padded (K_blk, N_blk) int32 per-block ranks of B.  Structure-only
    # planning input: B stays dense-stored (``b_mask`` is ``b_ranks > 0``),
    # the ranks refine modeled broadcast volume and the stationarity choice.
    b_ranks: np.ndarray | None = None
    # Padded (M_blk, N_blk) output block mask.  When set, gemm tasks whose
    # C block is dead are pruned from ``device_live`` and execution zeroes
    # the dead output blocks (the mask is an output *filter*).
    c_mask: np.ndarray | None = None
    # Panel transport: "broadcast" (panel broadcast along grid rows/cols,
    # today's pipeline) or "pull" (one-sided fetch of exactly the panels
    # this device's surviving gemms read — RDMA-SpGEMM style; fetch tasks
    # contend on the owner's clock in the simulator).
    comm_mode: str = "broadcast"
    # Which operand stays put: "C" (today's SUMMA layout), or "A"/"B"
    # (transposed layouts with a final C reduce-scatter — DBCSR-style;
    # ``repro.spgemm.stationarity`` chooses under ``stationarity="auto"``).
    stationarity: str = "C"
    # -- Norm-filter extensions (DBCSR-style on-the-fly filtering) -----------
    # Product-screening threshold this plan was built with: gemm tasks whose
    # ``||A_ik||_F * ||B_kj||_F`` bound fell below it were removed from the
    # masks / device liveness above, so the filtered structure bytes are what
    # the digest (and therefore the executable cache) sees.  0.0 = off, and
    # an eps-0 plan is bitwise identical to one planned without norms.
    filter_eps: float = 0.0
    # Additive Frobenius-norm error bound on C: the sum of every screened
    # product ``||A_ik||_F * ||B_kj||_F``.  Execution granularity is
    # panel-wise, so the measured error is <= this bound (a triple screened
    # at plan level may still ride along in a panel that survives for
    # other outputs — the bound never understates).
    filter_bound: float = 0.0
    # Propagated per-block output norm *bounds* (M_blk, N_blk float64) when
    # the plan was given operand norms: ``sum_k ||A_ik|| ||B_kj||`` over the
    # surviving triples.  Derived metadata (not digested) — chains feed it
    # forward as the next product's operand norms so iterative C <- A.B
    # gets progressively sparser.
    c_norms: np.ndarray | None = None

    # -- geometry -----------------------------------------------------------

    @property
    def p_row(self) -> int:
        return self.cfg.p_row

    @property
    def p_col(self) -> int:
        return self.cfg.p_col

    @property
    def padded_shapes(self) -> tuple[tuple[int, int], tuple[int, int]]:
        return (self.m_pad, self.k_pad), (self.k_pad, self.n_pad)

    def resolve_lookahead(self, k_steps: int | None = None) -> int:
        """The multiple-issue window executed for this plan: the tuned
        per-plan value when set, else the config's Eq.-(1) resolution."""
        if k_steps is None:
            k_steps = self.k_steps
        if self.lookahead is not None:
            return resolve_multi_issue(
                self.p_row, self.p_col, k_steps, self.lookahead
            )
        return self.cfg.resolve_lookahead(k_steps)

    # -- pruning accounting --------------------------------------------------

    @property
    def skipped_panels_global(self) -> int:
        """Panels pruned for the whole mesh (no broadcast emitted)."""
        return self.k_steps - len(self.live_panels)

    def skipped_panels_per_device(self) -> np.ndarray:
        """(p_row, p_col) int — panels dead for each device's C tile.

        Always >= ``skipped_panels_global`` elementwise; strictly greater
        wherever the mask structure is non-global (e.g. banded masks on a
        multi-row grid) — the finer pruning the planner feeds the local
        BSMM kernel.
        """
        if self.device_live is None:
            return np.zeros((self.p_row, self.p_col), dtype=np.int64)
        return self.k_steps - self.device_live.sum(axis=2)

    def digest(self) -> str:
        """Stable content hash of every execution-relevant static field.

        Two plans with the same digest describe the same execution — grid
        fingerprint (``Grid.fingerprint``: axes, sizes, device type), grid
        axes, strategy, padded geometry, panel schedule, masks, rank
        structure, local implementation and the resolved multiple-issue
        window are all folded in.  It will key the executable cache
        (ROADMAP A3).  Memoized on the instance.
        """
        cached = self.__dict__.get("_digest")
        if cached is not None:
            return cached
        cfg = self.cfg
        h = hashlib.sha1()
        h.update(
            repr((
                cfg.grid.fingerprint(), cfg.row_axis, cfg.col_axis,
                cfg.strategy, cfg.k_blocks, cfg.lookahead,
                str(cfg.accum_dtype), cfg.local_matmul,
                self.m, self.k, self.n, self.m_pad, self.k_pad,
                self.n_pad, self.k_steps, self.kb_width,
                self.live_panels, self.local_impl, self.local_block,
                self.itemsize, self.lookahead, self.resolve_lookahead(),
                self.comm_mode, self.stationarity,
            )).encode()
        )
        for arr in (
            self.a_mask, self.b_mask, self.device_live, self.local_cols,
            self.a_ranks, self.b_ranks, self.c_mask,
        ):
            if arr is None:
                h.update(b"|none")
            else:
                h.update(b"|")
                h.update(np.ascontiguousarray(arr).tobytes())
        digest = h.hexdigest()
        self.__dict__["_digest"] = digest  # frozen: write storage directly
        return digest

    def summary(self) -> dict:
        """JSON-able digest for benchmarks / logging."""
        skipped = self.skipped_panels_per_device()
        return {
            "shape": [self.m, self.k, self.n],
            "padded_shape": [self.m_pad, self.k_pad, self.n_pad],
            "grid": [self.p_row, self.p_col],
            "strategy": self.cfg.strategy,
            "local_impl": self.local_impl,
            "comm_mode": self.comm_mode,
            "stationarity": self.stationarity,
            "k_steps": self.k_steps,
            "kb_width": self.kb_width,
            "live_panels": len(self.live_panels),
            "skipped_global": int(self.skipped_panels_global),
            "skipped_per_device_mean": float(skipped.mean()),
            "skipped_per_device_max": int(skipped.max()),
            "lookahead": self.resolve_lookahead(),
            "tuned": self.tuned,
            "filter_eps": self.filter_eps,
            "filter_bound": self.filter_bound,
            "fill_in": self.cost.fill_in,
            "flops_dense": self.cost.flops_dense,
            "flops_sparse": self.cost.flops_sparse,
            "flops_mask": self.cost.flops_mask,
            "mean_rank": (
                float(self.a_ranks[self.a_ranks > 0].mean())
                if self.a_ranks is not None and (self.a_ranks > 0).any()
                else None
            ),
            "comm_bytes": {
                s: float(v) for s, v in self.cost.comm_bytes.items()
            },
        }


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _panel_liveness(
    a_mask: np.ndarray,
    b_mask: np.ndarray,
    k_steps: int,
    p_row: int,
    p_col: int,
) -> tuple[list[int], np.ndarray, np.ndarray]:
    """Global live panels, per-device liveness, per-grid-column liveness.

    Returns ``(live, device_live, b_col)`` where ``device_live`` is
    (p_row, p_col, k_steps) bool and ``b_col`` is the (p_col, k_steps)
    per-grid-column panel liveness that ``_local_csr_cols`` reuses.
    Per-device refinement is applied on each side only when that side's
    block grid aligns with the device grid (blocks per shard is integral);
    otherwise that side falls back to its global column/row test.
    """
    m_blk, k_blk = a_mask.shape
    _, n_blk = b_mask.shape
    assert k_blk == k_steps
    a_any = a_mask.any(axis=0)  # (K_blk,)
    b_any = b_mask.any(axis=1)
    live = [kk for kk in range(k_steps) if a_any[kk] and b_any[kk]]

    if m_blk % p_row == 0:
        mb_loc = m_blk // p_row
        a_row = np.array(
            [
                a_mask[i * mb_loc : (i + 1) * mb_loc, :].any(axis=0)
                for i in range(p_row)
            ]
        )  # (p_row, K_blk)
    else:
        a_row = np.broadcast_to(a_any, (p_row, k_blk))
    if n_blk % p_col == 0:
        nb_loc = n_blk // p_col
        b_col = np.array(
            [
                b_mask[:, j * nb_loc : (j + 1) * nb_loc].any(axis=1)
                for j in range(p_col)
            ]
        )  # (p_col, K_blk)
    else:
        b_col = np.broadcast_to(b_any, (p_col, k_blk)).copy()
    device_live = a_row[:, None, :] & b_col[None, :, :]
    return live, device_live, b_col


def _local_csr_cols(
    a_mask: np.ndarray,
    b_col: np.ndarray,
    live: list[int],
    p_row: int,
    p_col: int,
) -> np.ndarray:
    """Per-device padded CSR column maps over the *gathered live panels*.

    ``cols[i, j, ib, s]`` is the position (0..L-1) within the gathered
    K-panel axis of the s-th live block for local block row ``ib`` on
    device (i, j), or -1.  A block is live for (i, j, ib) when A's block
    (global row ib, panel) is nonzero and the panel intersects B columns
    owned by grid column j (``b_col`` from ``_panel_liveness``).
    """
    m_blk, _ = a_mask.shape
    mb_loc = m_blk // p_row
    rows: dict[tuple[int, int, int], list[int]] = {}
    s_max = 1
    for i in range(p_row):
        for j in range(p_col):
            for ib in range(mb_loc):
                gb = i * mb_loc + ib
                cols = [
                    pos
                    for pos, kk in enumerate(live)
                    if a_mask[gb, kk] and b_col[j, kk]
                ]
                rows[(i, j, ib)] = cols
                s_max = max(s_max, len(cols))
    out = np.full((p_row, p_col, mb_loc, s_max), -1, dtype=np.int32)
    for (i, j, ib), cols in rows.items():
        out[i, j, ib, : len(cols)] = cols
    return out


def _pick_bn(n_loc: int, pref: int = 256) -> int:
    """Largest divisor of ``n_loc`` not exceeding ``pref``."""
    if n_loc <= pref:
        return n_loc
    for bn in range(pref, 0, -1):
        if n_loc % bn == 0:
            return bn
    return n_loc


def _pad_block_mask(
    mask: np.ndarray, blocks_pad: tuple[int, int]
) -> np.ndarray:
    """Extend a block mask with all-zero pad blocks to the padded grid."""
    rb, cb = mask.shape
    out = np.zeros(blocks_pad, dtype=bool)
    out[:rb, :cb] = mask
    return out


def _comm_model(
    *,
    m_loc: int,
    n_loc: int,
    k_pad: int,
    kb_width: int,
    live: int,
    k_steps: int,
    p_row: int,
    p_col: int,
    itemsize: int,
    a_live_elems: float | None = None,
    b_live_elems: float | None = None,
) -> dict:
    """Modeled per-device collective bytes for each execution strategy.

    Broadcast-as-allreduce (the static-SPMD idiom ``_bcast_panel`` uses)
    costs ~2x the panel bytes of a tree broadcast, and only globally-live
    panels are broadcast — these numbers match what ``_exec_procedural``
    / ``_exec_taskbased`` and both sparse executors actually move.  The
    bulk all-gather (``_exec_allgather``) and the ring collective matmul
    (``dist.collective_matmul.allgather_matmul``) are *sparsity-blind*:
    they move the full remote shards regardless of masks, so their bytes
    are not scaled by liveness (masked plans never execute them — the
    numbers say what switching would cost).

    ``a_live_elems`` overrides the A-side broadcast volume (summed over
    live panels): rank-sparse plans broadcast *factor* panels whose bytes
    follow the per-panel ranks, not the dense panel area.
    ``b_live_elems`` is the B-side mirror: block-sparse B panels move only
    their surviving blocks (mean over grid columns, summed over live
    panels) — same sizing the task graph's ``bcast_b`` tasks use.
    """
    del k_steps  # liveness already folded into `live`
    # psum/all_gather over a size-1 axis moves nothing — gate each
    # operand's term on its broadcast axis actually having peers.
    if a_live_elems is None:
        a_live_elems = float(m_loc * kb_width * live)
    if b_live_elems is None:
        b_live_elems = float(kb_width * n_loc * live)
    bcast = 2.0 * itemsize * (
        a_live_elems * (p_col > 1) + b_live_elems * (p_row > 1)
    )
    allgather = itemsize * (
        m_loc * k_pad * (p_col - 1) / max(p_col, 1)
        + k_pad * n_loc * (p_row - 1) / max(p_row, 1)
    )
    ring = itemsize * (m_loc / max(p_col, 1)) * k_pad * (p_col - 1)
    return {
        "procedural": bcast,
        "taskbased": bcast,
        "allgather": allgather,
        "ring": ring,
    }


def b_panel_live_elems(
    b_mask: np.ndarray | None,
    b_ranks: np.ndarray | None,
    *,
    bk_sz: int,
    bn_sz: int,
    p_col: int,
) -> np.ndarray | None:
    """(k_steps, p_col) surviving B-panel elements per grid column.

    The single sizing both ``PlanCost`` and the task graph's ``bcast_b``
    / ``fetch_b`` tasks use: panel ``kk``'s slab for grid column ``j``
    carries only its live blocks (rank-structured blocks charge their
    factor footprint past nothing — ``min(r (bk + bn), bk bn)``, the
    travel bound ``spgemm.structure.live_elems`` documents).  ``None``
    when the block grid does not align with the device columns (the full
    panel is the only honest answer then).
    """
    if b_mask is None:
        return None
    k_steps, n_blk = b_mask.shape
    if n_blk % p_col:
        return None
    nb_loc = n_blk // p_col
    out = np.zeros((k_steps, p_col))
    for j in range(p_col):
        sl = slice(j * nb_loc, (j + 1) * nb_loc)
        if b_ranks is None:
            out[:, j] = b_mask[:, sl].sum(axis=1) * float(bk_sz * bn_sz)
        else:
            elems = np.minimum(
                b_ranks[:, sl].astype(np.int64) * (bk_sz + bn_sz),
                bk_sz * bn_sz,
            ) * b_mask[:, sl]
            out[:, j] = elems.sum(axis=1).astype(np.float64)
    return out


def _refine_device_live_c(
    device_live: np.ndarray,
    a_mask: np.ndarray,
    b_mask: np.ndarray,
    c_mask: np.ndarray,
    p_row: int,
    p_col: int,
) -> np.ndarray:
    """Output-structure refinement of per-device panel liveness.

    Device (i, j) needs panel ``kk`` only if some addend ``A[mb, kk] @
    B[kk, nb]`` lands in a *live* C block of its tile — the symbolic
    contribution test ``a & b & c``.  Falls back to the input liveness
    when either block grid does not align with the device grid.
    """
    m_blk = a_mask.shape[0]
    n_blk = b_mask.shape[1]
    if m_blk % p_row or n_blk % p_col:
        return device_live
    mb_loc = m_blk // p_row
    nb_loc = n_blk // p_col
    out = device_live.copy()
    a64 = a_mask.astype(np.int64)
    b64 = b_mask.astype(np.int64)
    c64 = c_mask.astype(np.int64)
    for i in range(p_row):
        am_i = a64[i * mb_loc : (i + 1) * mb_loc, :]
        for j in range(p_col):
            bm_j = b64[:, j * nb_loc : (j + 1) * nb_loc]
            cm_ij = c64[
                i * mb_loc : (i + 1) * mb_loc,
                j * nb_loc : (j + 1) * nb_loc,
            ]
            contrib = np.einsum("mk,kn,mn->k", am_i, bm_j, cm_ij)
            out[i, j, :] &= contrib > 0
    return out


def _pull_comm_bytes(
    device_live: np.ndarray,
    live: list[int],
    *,
    k_steps: int,
    m_loc: int,
    kb_width: int,
    n_loc: int,
    p_row: int,
    p_col: int,
    itemsize: int,
    b_live_cols: np.ndarray | None,
    a_fetch_elems: dict[int, float] | None = None,
) -> float:
    """Modeled per-device comm bytes of the one-sided pull schedule.

    Every surviving (device, panel) pair fetches its A panel from the
    owning grid column and its B slab from the owning grid row, at factor
    1.0 (a one-sided get moves the payload once — no allreduce doubling).
    A fetch occupies *both* endpoints' comm clocks (receiver and owner,
    which is where owner contention appears in the simulator), so the
    per-device mean occupancy is twice the total fetched bytes over the
    device count.  Pull undercuts broadcast once the live-receiver count
    per owner drops below the broadcast factor — the RDMA-SpGEMM
    crossover the 16x16-grid sweep validates.
    """
    t_a = max(k_steps // p_col, 1)
    t_b = max(k_steps // p_row, 1)
    total = 0.0
    for kk in live:
        owner_col = kk // t_a
        owner_row = kk // t_b
        for i in range(p_row):
            for j in range(p_col):
                if not device_live[i, j, kk]:
                    continue
                if p_col > 1 and j != owner_col:
                    # rank-factorized A panels fetch their U/V factors
                    # instead of the dense slab (repro.spgemm pull + rank)
                    a_elems = (
                        a_fetch_elems[kk]
                        if a_fetch_elems is not None
                        else m_loc * kb_width
                    )
                    total += a_elems * itemsize
                if p_row > 1 and i != owner_row:
                    b_elems = (
                        float(b_live_cols[kk, j])
                        if b_live_cols is not None
                        else float(kb_width * n_loc)
                    )
                    total += b_elems * itemsize
    return 2.0 * total / max(p_row * p_col, 1)


def _resolve_stationarity(
    a_struct,
    b_struct,
    *,
    m: int,
    k: int,
    n: int,
    p_row: int,
    p_col: int,
    itemsize: int,
    stationarity: str,
    c_structure=None,
) -> tuple[str, dict[str, float]]:
    """Resolve ``stationarity="auto"`` through the spgemm chooser and
    return ``(choice, modeled total volumes)`` either way.  Lazy import:
    ``repro_torch.spgemm`` sits downstream of ``core`` in the import graph."""
    from repro_torch.spgemm.stationarity import (
        STATIONARITIES,
        choose_stationarity,
        stationarity_comm_volumes,
    )

    if stationarity == "auto":
        return choose_stationarity(
            a_struct, b_struct, m=m, k=k, n=n, p_row=p_row, p_col=p_col,
            itemsize=itemsize, c_structure=c_structure,
        )
    if stationarity not in STATIONARITIES:
        raise ValueError(
            f"stationarity={stationarity!r}: one of "
            f"{STATIONARITIES + ('auto',)}"
        )
    vols = stationarity_comm_volumes(
        a_struct, b_struct, m=m, k=k, n=n, p_row=p_row, p_col=p_col,
        itemsize=itemsize, c_structure=c_structure,
    )
    return stationarity, vols


@spanned("plan.build")
def plan_matmul(
    m: int,
    k: int,
    n: int,
    cfg: SummaConfig,
    *,
    a_mask: np.ndarray | None = None,
    b_mask: np.ndarray | None = None,
    a_ranks: BlockRankMap | None = None,
    b_ranks: BlockRankMap | None = None,
    c_mask: np.ndarray | None = None,
    rank_payload: bool = True,
    comm_mode: str = "broadcast",
    stationarity: str = "C",
    itemsize: int = 4,
    a_norms: np.ndarray | None = None,
    b_norms: np.ndarray | None = None,
    filter_eps: float = 0.0,
) -> MatmulPlan:
    """Plan C = A @ B on ``cfg``'s grid; the single schedule source.

    ``a_mask``/``b_mask`` are block masks over the *logical* shapes; block
    sizes must divide them evenly.  Either may be ``None`` (treated as a
    single all-ones block on that side).  ``a_ranks`` refines A's mask
    into per-block numerical ranks (``BlockRankMap``, or anything with a
    ``rank_map()`` such as ``RankCSR``); it replaces ``a_mask`` and makes
    the cost model charge each block its factored gemm cost and its
    factor-sized broadcast bytes.  ``rank_payload=False`` says the caller
    has no factor payload (dense-stored A, rank map for useful-work
    accounting and pruning only): the plan then schedules — and the task
    graph / tuner model — the masked DAG it will actually execute, not
    the factored pipeline.

    SpGEMM extensions (``repro.spgemm``): ``b_ranks`` is B's
    structure-only rank map (replaces ``b_mask``; B stays dense-stored);
    ``c_mask`` is the output block mask — gemm tasks whose C block is
    dead are pruned from the per-device liveness and execution zeroes the
    dead output blocks; ``comm_mode="pull"`` plans one-sided panel
    fetches instead of broadcasts (needs block structure, C-stationary
    only); ``stationarity`` picks which operand stays put ("auto" runs
    the comm-volume chooser over C/A/B).

    Norm filtering (DBCSR-style, ``filter_eps > 0``): ``a_norms`` /
    ``b_norms`` are per-block Frobenius norms on the operand block grids
    (``core.sparsity.block_norms`` / ``rank_csr_norms``).  Every (i, k, j)
    product whose bound ``||A_ik||_F * ||B_kj||_F`` falls below
    ``filter_eps`` is screened: the operand masks, the output mask, and
    the per-device panel liveness are all refined to the surviving
    triples, so downstream consumers — the task graph, the simulator, the
    executors, and ``digest()`` — see the filtered structure.  Pruning is
    applied at the engine's task granularity (mask rows/cols, output
    blocks, per-device k-panels — the projections of the screened triple
    set): a screened (i, k, j) whose row, column, and output block all
    stay live elsewhere is still computed by the panel product, which
    only *lowers* the realized error.  The plan
    records the additive error bound ``filter_bound`` (the sum of the
    screened products): ``||C_exact - C_filtered||_F <= filter_bound``,
    by submultiplicativity of the Frobenius norm per product and the
    triangle inequality over the sum.  ``filter_eps=0`` is a no-op and
    returns a plan bitwise identical (same digest) to one planned without
    norms.

    Returns a plan whose ``padded_shapes`` the caller pads operands to
    before ``core.summa.execute_plan`` (or ``execute_rank_plan`` for a
    rank payload).  Every route is planned here, and every one runs:
    C-, A- and B-stationary, broadcast and pull, dense, masked and rank
    payloads.
    """
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"bad shape ({m},{k})x({k},{n})")
    if comm_mode not in ("broadcast", "pull"):
        raise ValueError(
            f"comm_mode={comm_mode!r}: one of ('broadcast', 'pull')"
        )
    if comm_mode == "pull" and stationarity not in ("C", "auto"):
        raise ValueError(
            "comm_mode='pull' is a C-stationary pipeline; plan pull and "
            "A-/B-stationary schedules separately"
        )
    if not (np.isfinite(filter_eps) and filter_eps >= 0.0):
        raise ValueError(
            f"filter_eps must be finite and >= 0, got {filter_eps}"
        )
    if (a_norms is None) != (b_norms is None):
        raise ValueError(
            "per-block norms come in pairs: pass both a_norms and b_norms"
        )
    if filter_eps > 0.0 and a_norms is None:
        raise ValueError(
            "filter_eps > 0 needs per-block norms for both operands "
            "(a_norms=/b_norms= — core.sparsity.block_norms)"
        )
    if filter_eps <= 0.0:
        # Filtering off: norms are inert, and the plan must be bitwise
        # identical to one planned without them (the digest/no-op contract
        # the executable cache and ``api.plan``'s cache key rely on).
        a_norms = b_norms = None
    if a_norms is not None:
        # A norm grid carries block structure: synthesize the support masks
        # when the caller gave none, so dense-stored operands can still be
        # screened.
        if a_mask is None and a_ranks is None:
            a_mask = np.asarray(a_norms, np.float64) > 0.0
        if b_mask is None and b_ranks is None:
            b_mask = np.asarray(b_norms, np.float64) > 0.0
    p_row, p_col = cfg.p_row, cfg.p_col
    if a_ranks is not None:
        if a_mask is not None:
            raise ValueError("pass either a_mask or a_ranks for A, not both")
        if hasattr(a_ranks, "rank_map"):  # RankCSR and friends
            a_ranks = a_ranks.rank_map()
        if a_ranks.shape != (m, k):
            raise ValueError(
                f"a_ranks tiles {a_ranks.shape}, expected ({m},{k})"
            )
        a_mask = a_ranks.mask
    if b_ranks is not None:
        if b_mask is not None:
            raise ValueError("pass either b_mask or b_ranks for B, not both")
        if hasattr(b_ranks, "rank_map"):  # RankCSR and friends
            b_ranks = b_ranks.rank_map()
        if b_ranks.shape != (k, n):
            raise ValueError(
                f"b_ranks tiles {b_ranks.shape}, expected ({k},{n})"
            )
        b_mask = b_ranks.mask
    masked = a_mask is not None or b_mask is not None
    if c_mask is not None:
        c_mask = np.asarray(c_mask, dtype=bool)
        if not masked:
            raise ValueError(
                "c_mask needs block structure on A or B to prune against"
            )
    if not masked:
        if comm_mode == "pull":
            raise ValueError(
                "comm_mode='pull' needs block structure to size fetches"
            )
        kmult = math.lcm(p_row, p_col)
        if cfg.k_blocks:
            kmult = math.lcm(kmult, cfg.k_blocks)
        m_pad = _ceil_to(m, p_row)
        n_pad = _ceil_to(n, p_col)
        k_pad = _ceil_to(k, kmult)
        k_steps = cfg.resolve_k_blocks(k_pad)
        kb_width = k_pad // k_steps
        if (k_pad // p_col) % kb_width or (k_pad // p_row) % kb_width:
            raise ValueError(
                f"panel width {kb_width} must divide local K shards "
                f"({k_pad // p_col}, {k_pad // p_row})"
            )
        m_loc, n_loc = m_pad // p_row, n_pad // p_col
        stationarity, stat_vols = _resolve_stationarity(
            None, None, m=m_pad, k=k_pad, n=n_pad, p_row=p_row, p_col=p_col,
            itemsize=itemsize, stationarity=stationarity,
        )
        flops = 2.0 * m_pad * k_pad * n_pad
        comm = _comm_model(
            m_loc=m_loc, n_loc=n_loc, k_pad=k_pad, kb_width=kb_width,
            live=k_steps, k_steps=k_steps, p_row=p_row, p_col=p_col,
            itemsize=itemsize,
        )
        p_all = max(p_row * p_col, 1)
        comm["c_stationary"] = stat_vols["C"] / p_all
        comm["a_stationary"] = stat_vols["A"] / p_all
        comm["b_stationary"] = stat_vols["B"] / p_all
        cost = PlanCost(
            flops_dense=flops,
            flops_sparse=flops,
            comm_bytes=comm,
            fill_in=1.0,
            flops_mask=flops,
        )
        return MatmulPlan(
            cfg=cfg, m=m, k=k, n=n, m_pad=m_pad, k_pad=k_pad, n_pad=n_pad,
            k_steps=k_steps, kb_width=kb_width,
            live_panels=tuple(range(k_steps)),
            a_mask=None, b_mask=None, device_live=None,
            local_cols=None, local_block=None, local_impl="dense",
            cost=cost, itemsize=itemsize,
            comm_mode=comm_mode, stationarity=stationarity,
        )

    # -- masked path ---------------------------------------------------------
    # One-sided masks: synthesize all-ones blocking on the other side.
    # Use one block per grid shard when the extent divides the grid (keeps
    # padding minimal and the kernel block size large); otherwise a single
    # block-per-element fallback so padding stays at the grid minimum.
    if a_mask is None:
        if c_mask is not None and m % c_mask.shape[0] == 0:
            m_blocks = c_mask.shape[0]  # match the output filter's grid
        else:
            m_blocks = p_row if m % p_row == 0 else m
        a_mask = np.ones((m_blocks, np.asarray(b_mask).shape[0]), dtype=bool)
    if b_mask is None:
        if c_mask is not None and n % c_mask.shape[1] == 0:
            n_blocks = c_mask.shape[1]
        else:
            n_blocks = p_col if n % p_col == 0 else n
        b_mask = np.ones((np.asarray(a_mask).shape[1], n_blocks), dtype=bool)
    a_mask = np.asarray(a_mask, dtype=bool)
    b_mask = np.asarray(b_mask, dtype=bool)
    m_blk, k_blk = a_mask.shape
    k_blk2, n_blk = b_mask.shape
    if k_blk != k_blk2:
        raise ValueError(
            f"A col-blocks ({k_blk}) must equal B row-blocks ({k_blk2})"
        )
    if m % m_blk or k % k_blk or n % n_blk:
        raise ValueError(
            f"masks {a_mask.shape}/{b_mask.shape} must evenly block "
            f"({m},{k})x({k},{n})"
        )
    if c_mask is not None and c_mask.shape != (m_blk, n_blk):
        raise ValueError(
            f"c_mask {c_mask.shape} must match the output block grid "
            f"({m_blk},{n_blk})"
        )
    bm_sz, bk_sz, bn_sz = m // m_blk, k // k_blk, n // n_blk
    # Padded shapes stay block-divisible AND grid-divisible; K additionally
    # keeps every panel inside a single device shard on both operands.
    m_pad = _ceil_to(m, math.lcm(bm_sz, p_row))
    n_pad = _ceil_to(n, math.lcm(bn_sz, p_col))
    k_pad = _ceil_to(k, bk_sz * math.lcm(p_row, p_col))
    a_mask_p = _pad_block_mask(a_mask, (m_pad // bm_sz, k_pad // bk_sz))
    b_mask_p = _pad_block_mask(b_mask, (k_pad // bk_sz, n_pad // bn_sz))
    k_steps = k_pad // bk_sz  # one panel per K block
    kb_width = bk_sz

    # -- norm screening (DBCSR-style product filter) -------------------------
    # Refine the structure *before* liveness so every downstream consumer
    # (panel schedule, device liveness, CSR maps, cost model, digest) sees
    # only the surviving triples.
    a_norms_p = b_norms_p = None
    keep = None
    c_norms = None
    filter_bound = 0.0
    if a_norms is not None:
        def _pad_norms(norms, blocks, blocks_pad, side):
            arr = np.asarray(norms, dtype=np.float64)
            if arr.shape != blocks:
                raise ValueError(
                    f"{side} norm grid {arr.shape} must match the block "
                    f"grid {blocks}"
                )
            out = np.zeros(blocks_pad)
            out[: blocks[0], : blocks[1]] = arr
            return out

        a_norms_p = _pad_norms(
            a_norms, (m_blk, k_blk), a_mask_p.shape, "a_norms"
        ) * a_mask_p
        b_norms_p = _pad_norms(
            b_norms, (k_blk, n_blk), b_mask_p.shape, "b_norms"
        ) * b_mask_p
        from repro_torch.spgemm.structure import filter_keep, output_norms

        if filter_eps > 0.0:
            keep, filter_bound = filter_keep(a_norms_p, b_norms_p, filter_eps)
            a_mask_p = a_mask_p & keep.any(axis=2)
            b_mask_p = b_mask_p & keep.any(axis=0)
        c_norms = output_norms(a_norms_p, b_norms_p, keep)

    live, device_live, b_col = _panel_liveness(
        a_mask_p, b_mask_p, k_steps, p_row, p_col
    )
    m_blk_p = m_pad // bm_sz

    c_mask_p = None
    if c_mask is not None:
        c_mask_p = _pad_block_mask(c_mask, (m_pad // bm_sz, n_pad // bn_sz))
    if keep is not None:
        # Screened outputs join the output filter: a C block all of whose
        # addends were dropped is dead (its norm bound rides in c_norms
        # only as 0).
        c_keep = keep.any(axis=1)
        c_mask_p = c_keep if c_mask_p is None else (c_mask_p & c_keep)
    if c_mask_p is not None:
        # Dead-output pruning: drop gemm tasks whose C block the output
        # filter kills, then re-derive the live panel set.
        device_live = _refine_device_live_c(
            device_live, a_mask_p, b_mask_p, c_mask_p, p_row, p_col
        )
        live = [kk for kk in live if device_live[:, :, kk].any()]
    if c_norms is not None and c_mask_p is not None:
        c_norms = np.where(c_mask_p, c_norms, 0.0)

    a_ranks_p = None
    if a_ranks is not None:
        a_ranks_p = np.zeros((m_pad // bm_sz, k_pad // bk_sz), np.int32)
        a_ranks_p[: a_ranks.m_blocks, : a_ranks.k_blocks] = a_ranks.ranks
        if keep is not None:
            a_ranks_p = np.where(a_mask_p, a_ranks_p, 0)
    b_ranks_p = None
    if b_ranks is not None:
        b_ranks_p = np.zeros((k_pad // bk_sz, n_pad // bn_sz), np.int32)
        b_ranks_p[: b_ranks.m_blocks, : b_ranks.k_blocks] = b_ranks.ranks
        if keep is not None:
            b_ranks_p = np.where(b_mask_p, b_ranks_p, 0)

    a_struct = (
        BlockRankMap(ranks=a_ranks_p, bm=bm_sz, bk=bk_sz)
        if a_ranks_p is not None
        else a_mask_p
    )
    b_struct = (
        BlockRankMap(ranks=b_ranks_p, bm=bk_sz, bk=bn_sz)
        if b_ranks_p is not None
        else b_mask_p
    )
    stationarity, stat_vols = _resolve_stationarity(
        a_struct, b_struct, m=m_pad, k=k_pad, n=n_pad,
        p_row=p_row, p_col=p_col, itemsize=itemsize,
        stationarity=stationarity, c_structure=c_mask_p,
    )

    local_cols = None
    local_block = None
    local_impl = "masked"
    # The specialized local executors (factored rank pipeline, BSMM kernel)
    # exist only for C-stationary pipelines; A-/B-stationary schedules run
    # the masked DAG.  The rank pipeline supports both comm modes — pull
    # fetches the U/V factors themselves (``_exec_ranksparse_pull``) —
    # while BSMM stays broadcast-only.
    plain_pipeline = comm_mode == "broadcast" and stationarity == "C"
    if a_ranks_p is not None:
        # The factor layout (U panels of uniform width, V rows batched per
        # local block row) needs a payload and row blocks aligned to the
        # grid; otherwise execution (and therefore the schedule model) is
        # the dense-stored masked DAG.
        if rank_payload and m_blk_p % p_row == 0 and stationarity == "C":
            local_impl = "ranksparse"
    # BSMM needs row blocks aligned to the grid and big enough to make a
    # sane kernel block (>= 8 rows: TPU sublane minimum).
    elif (
        cfg.local_matmul == "pallas"
        and live
        and m_blk_p % p_row == 0
        and bm_sz >= 8
        and plain_pipeline
    ):
        local_cols = _local_csr_cols(a_mask_p, b_col, live, p_row, p_col)
        local_block = (bm_sz, kb_width, _pick_bn(n_pad // p_col))
        local_impl = "bsmm"

    sparse, dense = mask_matmul_flops(a_mask_p, b_mask_p, bm_sz, bk_sz, bn_sz)
    m_loc, n_loc = m_pad // p_row, n_pad // p_col
    if c_mask_p is not None:
        # Useful flops count only the (i, kk) x (kk, j) pairs whose output
        # block survives the filter.
        pairs = a_mask_p.astype(np.int64) @ b_mask_p.astype(np.int64)
        sparse = 2.0 * bm_sz * bk_sz * bn_sz * float(pairs[c_mask_p].sum())
    mask_flops = float(sparse)
    a_live_elems = None
    a_fetch_elems = None
    if a_ranks_p is not None:
        from repro_torch.core.sparsity import (
            rank_matmul_flops,
            rank_panel_factored_comm,
        )

        padded_map = BlockRankMap(ranks=a_ranks_p, bm=bm_sz, bk=bk_sz)
        rank_flops, _, _ = rank_matmul_flops(padded_map, b_mask_p, bn_sz)
        sparse = rank_flops
        if local_impl == "ranksparse":
            # Broadcast volume of the A-side panels: a factored panel
            # moves a (m_loc, r_k) U panel plus (mb_loc, r_k, bk) V rows
            # (r_k = the panel's max block rank, the executor's static
            # width); past r* = bm·bk/(bm+bk) the panel is reconstructed
            # owner-side and dense panel bytes travel — the exact
            # per-panel comm decision the executor takes
            # (sparsity.rank_panel_factored_comm).
            mb_loc = m_blk_p // p_row
            r_live = a_ranks_p.max(axis=0)  # (K_blk,) per-panel width
            a_live_elems = 0.0
            a_fetch_elems = {}
            for kk in live:
                r_k = int(r_live[kk])
                if rank_panel_factored_comm(r_k, bm_sz, bk_sz):
                    elems = m_loc * r_k + mb_loc * r_k * bk_sz
                else:
                    elems = m_loc * bk_sz
                a_live_elems += elems
                a_fetch_elems[kk] = float(elems)
    b_live_cols = b_panel_live_elems(
        b_mask_p, b_ranks_p, bk_sz=bk_sz, bn_sz=bn_sz, p_col=p_col
    )
    b_live_elems = None
    if b_live_cols is not None:
        b_live_elems = (
            float(b_live_cols[np.asarray(live, dtype=int)].mean(axis=1).sum())
            if live
            else 0.0
        )
    comm = _comm_model(
        m_loc=m_loc, n_loc=n_loc, k_pad=k_pad, kb_width=kb_width,
        live=len(live), k_steps=k_steps, p_row=p_row, p_col=p_col,
        itemsize=itemsize, a_live_elems=a_live_elems,
        b_live_elems=b_live_elems,
    )
    comm["pull"] = _pull_comm_bytes(
        device_live, live, k_steps=k_steps, m_loc=m_loc, kb_width=kb_width,
        n_loc=n_loc, p_row=p_row, p_col=p_col, itemsize=itemsize,
        b_live_cols=b_live_cols,
        a_fetch_elems=a_fetch_elems if local_impl == "ranksparse" else None,
    )
    p_all = max(p_row * p_col, 1)
    comm["c_stationary"] = stat_vols["C"] / p_all
    comm["a_stationary"] = stat_vols["A"] / p_all
    comm["b_stationary"] = stat_vols["B"] / p_all
    cost = PlanCost(
        flops_dense=float(dense),
        flops_sparse=float(sparse),
        comm_bytes=comm,
        fill_in=float(sparse) / float(dense) if dense else 0.0,
        flops_mask=mask_flops,
    )
    return MatmulPlan(
        cfg=cfg, m=m, k=k, n=n, m_pad=m_pad, k_pad=k_pad, n_pad=n_pad,
        k_steps=k_steps, kb_width=kb_width, live_panels=tuple(live),
        a_mask=a_mask_p, b_mask=b_mask_p, device_live=device_live,
        local_cols=local_cols, local_block=local_block,
        local_impl=local_impl, cost=cost, itemsize=itemsize,
        a_ranks=a_ranks_p, b_ranks=b_ranks_p, c_mask=c_mask_p,
        comm_mode=comm_mode, stationarity=stationarity,
        filter_eps=float(filter_eps), filter_bound=filter_bound,
        c_norms=c_norms,
    )
