"""User-facing API for distributed (block-sparse) matrix multiplication.

``DistributedMatmul`` is a thin front-end over the ``core.plan`` planner:
every call — dense, block-sparse, one-sided mask — resolves to one cached
``MatmulPlan`` (keyed by shapes + mask content + strategy) that
``core.summa.execute_plan`` interprets on this rank's tiles.  The
front-end pads the global operands to the plan's shapes, cuts this
rank's tiles, runs the plan, gathers C over the grid and crops it.

A ``RankCSR`` in ``a_ranks`` with ``a=None`` is the rank-sparse factor
route: A is multiplied as its block factors U·V (``core.summa.
execute_rank_plan``).

``tune=True`` runs the schedule tuner (``sched.tuner.tune_plan``) over
the plan and executes its winner.  ``NonuniformMatmul`` multiplies
nonuniformly blocked matrices by bucketing their logical blocks into
uniform physical tiles (``core.blocking``) around a ``DistributedMatmul``.
``contract``/``contract_chain`` are the block-sparse tensor front-end
(``core.contract``) on this instance's plan and contraction caches.

``compiled=True`` (the default) dispatches the executable cache of
``core.summa`` (one program per plan digest; equal to the eager route
bitwise); ``compiled=False`` runs the eager interpreters everywhere.

The port of ``repro.core.api``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.spans import ROOT, span, spanned
from repro_torch.core import blocking as bk
from repro_torch.core import summa as sm
from repro_torch.core.grid import Grid
from repro_torch.core.plan import MatmulPlan, mask_key, plan_matmul, rank_key
from repro_torch.core.sparsity import (
    BlockRankMap,
    RankCSR,
    norms_key,
    rank_csr_norms,
)

__all__ = ["DistributedMatmul", "NonuniformMatmul", "pad_to_multiple"]


def pad_to_multiple(x: torch.Tensor, multiples: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad each dim of ``x`` up to the next multiple."""
    return _pad_to_shape(
        x, tuple(-(-d // m) * m for d, m in zip(x.shape, multiples))
    )


def _pad_to_shape(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    pads = [t - d for d, t in zip(x.shape, shape)]
    if not any(pads):
        return x
    flat = []
    for p in reversed(pads):  # F.pad lists the last dim first
        flat += [0, p]
    return F.pad(x, flat)


@dataclasses.dataclass
class DistributedMatmul:
    """C = A @ B on a 2-D ``Grid``, task-based SUMMA under the hood.

    Example::

        mm = DistributedMatmul(Grid.local("cuda"), strategy="taskbased",
                               k_blocks=8, local_matmul="pallas")
        c = mm(a, b)                       # dense
        c = mm(a, b, a_mask=am, b_mask=bm) # block-sparse
        c = mm(a, b, b_mask=bm)            # one-sided block structure
        c = mm(None, b, a_ranks=rcsr)      # A as low-rank block factors

    Operands are global (M, K) / (K, N) tensors or numpy arrays on any
    device; each rank moves its own tiles to ``grid.device`` and every
    rank returns the whole C there.  Each distinct (shapes, masks,
    strategy) builds its ``MatmulPlan`` once.
    """

    grid: Grid
    row_axis: str = "data"
    col_axis: str = "model"
    strategy: str = "taskbased"
    k_blocks: int | None = None
    lookahead: int | None = None
    accum_dtype: torch.dtype = torch.float32
    local_matmul: str = "xla"
    #: dispatch cached executables (core.summa, core.contract); False runs
    #: the eager interpreters everywhere
    compiled: bool = True
    _plan_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    # spec/tiling-keyed matricization geometry and contraction step
    # programs of core.contract
    _contract_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    _cache_stats: dict = dataclasses.field(
        default_factory=lambda: {
            "plan_hits": 0, "plan_misses": 0,
            "geom_hits": 0, "geom_misses": 0,
            "step_hits": 0, "step_misses": 0, "step_retraces": 0,
        },
        repr=False, compare=False,
    )

    def config(self, strategy: str | None = None) -> sm.SummaConfig:
        return sm.SummaConfig(
            grid=self.grid,
            row_axis=self.row_axis,
            col_axis=self.col_axis,
            strategy=strategy or self.strategy,  # type: ignore[arg-type]
            k_blocks=self.k_blocks,
            lookahead=self.lookahead,
            accum_dtype=self.accum_dtype,
            local_matmul=self.local_matmul,  # type: ignore[arg-type]
        )

    # -- planning ------------------------------------------------------------

    @spanned("plan.lookup")
    def plan(
        self,
        m: int,
        k: int,
        n: int,
        *,
        a_mask: np.ndarray | None = None,
        b_mask: np.ndarray | None = None,
        a_ranks: BlockRankMap | RankCSR | None = None,
        b_ranks: BlockRankMap | RankCSR | None = None,
        c_mask: np.ndarray | None = None,
        strategy: str | None = None,
        itemsize: int = 4,
        tune: bool = False,
        lookahead: int | None = None,
        comm_mode: str = "broadcast",
        stationarity: str = "C",
        a_norms: np.ndarray | None = None,
        b_norms: np.ndarray | None = None,
        filter_eps: float = 0.0,
        k_blocks: int | None = None,
    ) -> MatmulPlan:
        """The (cached) execution plan for a (M, K) x (K, N) product.

        Takes the reference's planning inputs (see ``core.plan.
        plan_matmul``).  A ``RankCSR`` in ``a_ranks`` plans the factor
        route (``local_impl="ranksparse"`` where the grid allows); a
        ``BlockRankMap`` refines the cost model of a dense-stored A only.
        The two are keyed apart, so one structure given both ways gets two
        plans.  ``tune=True`` runs the schedule tuner
        (``sched.tuner.tune_plan``) over the plan: the cached result
        carries the simulated-makespan-optimal strategy / k_blocks /
        lookahead / comm mode / stationarity, and its ``tuned`` record.
        ``tune`` is part of the cache key, so tuned and untuned plans of
        one product never alias.  ``lookahead`` pins the window; it
        overrides a tuned one.
        """
        rank_payload = isinstance(a_ranks, RankCSR)
        key = (
            m, k, n, mask_key(a_mask), mask_key(b_mask), rank_key(a_ranks),
            rank_payload, strategy or self.strategy, itemsize, tune,
            lookahead, rank_key(b_ranks), mask_key(c_mask), comm_mode,
            stationarity,
        )
        if k_blocks is not None:
            key = key + ("k_blocks", int(k_blocks))
        if filter_eps > 0.0:
            key = key + (
                float(filter_eps), norms_key(a_norms), norms_key(b_norms),
            )
        plan = self._plan_cache.get(key)
        if plan is None:
            self._cache_stats["plan_misses"] += 1
            cfg = self.config(strategy)
            if k_blocks is not None:
                cfg = dataclasses.replace(cfg, k_blocks=int(k_blocks))
            plan = plan_matmul(
                m, k, n, cfg,
                a_mask=a_mask, b_mask=b_mask,
                a_ranks=a_ranks.rank_map() if rank_payload else a_ranks,
                b_ranks=(b_ranks.rank_map() if isinstance(b_ranks, RankCSR)
                         else b_ranks),
                c_mask=c_mask, rank_payload=rank_payload,
                comm_mode=comm_mode, stationarity=stationarity,
                itemsize=itemsize, a_norms=a_norms, b_norms=b_norms,
                filter_eps=filter_eps,
            )
            if tune:
                from repro_torch.sched.tuner import tune_plan  # no cycle

                plan = tune_plan(plan)
            if lookahead is not None:
                plan = dataclasses.replace(plan, lookahead=int(lookahead))
            self._plan_cache[key] = plan
        else:
            self._cache_stats["plan_hits"] += 1
        return plan

    # -- observability -------------------------------------------------------

    def cache_stats(self) -> dict:
        """Hit/miss/build counters of every cache on the hot path.

        ``plan``: the ``MatmulPlan`` cache of this instance.
        ``contract``: the matricization-geometry cache (``geom_*``) and the
        contraction step programs (``step_*``; ``step_retraces`` counts
        program builds, equal to ``step_misses`` when keys are stable).
        ``executable``: the process-wide executable cache of
        ``core.summa``.
        """
        s = self._cache_stats
        return {
            "plan": {
                "size": len(self._plan_cache),
                "hits": s["plan_hits"], "misses": s["plan_misses"],
            },
            "contract": {
                "size": len(self._contract_cache),
                "geom_hits": s["geom_hits"], "geom_misses": s["geom_misses"],
                "step_hits": s["step_hits"], "step_misses": s["step_misses"],
                "step_retraces": s["step_retraces"],
            },
            "executable": sm.executable_cache_stats(),
        }

    def reset_cache_stats(self) -> None:
        """Zero the counters (cache *contents* are kept)."""
        for k in self._cache_stats:
            self._cache_stats[k] = 0

    # -- call paths ----------------------------------------------------------

    def __call__(
        self,
        a,
        b,
        *,
        a_mask: np.ndarray | None = None,
        b_mask: np.ndarray | None = None,
        a_ranks: BlockRankMap | RankCSR | None = None,
        b_ranks: BlockRankMap | RankCSR | None = None,
        c_mask: np.ndarray | None = None,
        strategy: str | None = None,
        tune: bool = False,
        lookahead: int | None = None,
        comm_mode: str = "broadcast",
        stationarity: str = "C",
        a_norms: np.ndarray | None = None,
        b_norms: np.ndarray | None = None,
        filter_eps: float = 0.0,
    ) -> torch.Tensor:
        """C = A @ B, on ``grid.device``.  ``a_mask``/``b_mask`` give block
        structure, ``c_mask`` filters the output block grid, and
        ``a_norms``/``b_norms`` with ``filter_eps > 0`` screen small
        products, all as in the reference.  ``a_ranks`` plans A
        block-rank-sparse:

        * a ``RankCSR`` is the A operand itself — pass ``a=None`` — and
          execution multiplies its factors (``_call_ranksparse``);
        * a ``BlockRankMap`` refines the plan only: ``a`` is dense-stored
          and runs the masked DAG over the ``rank > 0`` mask.
        """
        if a_mask is not None and a_ranks is not None:
            raise ValueError("pass either a_mask or a_ranks for A, not both")
        if isinstance(a_ranks, RankCSR):
            if a is not None:
                # the factors may be a lossy truncation of a dense twin:
                # make the caller choose one representation
                raise ValueError(
                    "pass a=None when a_ranks is a RankCSR: the "
                    "factorization is the A operand (use "
                    "RankCSR.to_dense() if you meant the dense product)"
                )
            return self._call_ranksparse(
                a_ranks, b, b_mask=b_mask, b_ranks=b_ranks, c_mask=c_mask,
                strategy=strategy, tune=tune, lookahead=lookahead,
                comm_mode=comm_mode, stationarity=stationarity,
                a_norms=a_norms, b_norms=b_norms, filter_eps=filter_eps,
            )
        if a is None:
            raise ValueError("a=None requires a_ranks to be a RankCSR")
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        m, k = a.shape
        k2, n = b.shape
        if k != k2:
            raise ValueError(
                f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}"
            )
        with span(ROOT, device=self.grid.device):
            plan = self.plan(
                m, k, n, a_mask=a_mask, b_mask=b_mask, a_ranks=a_ranks,
                b_ranks=b_ranks, c_mask=c_mask, strategy=strategy,
                itemsize=a.element_size(), tune=tune, lookahead=lookahead,
                comm_mode=comm_mode, stationarity=stationarity,
                a_norms=a_norms, b_norms=b_norms, filter_eps=filter_eps,
            )
            return self._run(a, b, plan, compiled=self.compiled)

    def _run(self, a, b, plan: MatmulPlan, *, compiled: bool) -> torch.Tensor:
        """C = A @ B under ``plan``, made for these operands' shapes: pad,
        cut this rank's tiles, execute, gather and crop."""
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        (mp, kp), (_, np_) = plan.padded_shapes
        cfg = plan.cfg
        with span("api.pad", device=cfg.grid.device):
            a_loc = sm.local_tile(_pad_to_shape(a, (mp, kp)), cfg)
            b_loc = sm.local_tile(_pad_to_shape(b, (kp, np_)), cfg)
        c_loc = sm.execute_plan(a_loc, b_loc, plan, compiled=compiled)
        del a_loc, b_loc
        with span("api.crop", device=cfg.grid.device):
            return sm.gather_tiles(c_loc, cfg)[:a.shape[0], :b.shape[1]]

    def _call_ranksparse(
        self,
        a_ranks: RankCSR,
        b,
        *,
        b_mask: np.ndarray | None = None,
        b_ranks: BlockRankMap | RankCSR | None = None,
        c_mask: np.ndarray | None = None,
        strategy: str | None = None,
        tune: bool = False,
        lookahead: int | None = None,
        comm_mode: str = "broadcast",
        stationarity: str = "C",
        a_norms: np.ndarray | None = None,
        b_norms: np.ndarray | None = None,
        filter_eps: float = 0.0,
    ) -> torch.Tensor:
        b = torch.as_tensor(b)
        m, k = a_ranks.shape
        k2, n = b.shape
        if k != k2:
            raise ValueError(
                f"contraction mismatch {a_ranks.shape} @ {tuple(b.shape)}"
            )
        if filter_eps > 0.0 and a_norms is None:
            # the factor payload carries its own norms, exact from U and V
            a_norms = rank_csr_norms(a_ranks)
        with span(ROOT, device=self.grid.device):
            plan = self.plan(
                m, k, n, b_mask=b_mask, b_ranks=b_ranks, c_mask=c_mask,
                a_ranks=a_ranks, strategy=strategy,
                itemsize=b.element_size(), tune=tune, lookahead=lookahead,
                comm_mode=comm_mode, stationarity=stationarity,
                a_norms=a_norms, b_norms=b_norms, filter_eps=filter_eps,
            )
            return self._run_rank(a_ranks, b, plan, compiled=self.compiled)

    def _run_rank(self, a_ranks: RankCSR, b, plan: MatmulPlan, *,
                  compiled: bool) -> torch.Tensor:
        """C = A @ B under a plan of the factor route, A the ``RankCSR``."""
        b = torch.as_tensor(b)
        cfg = plan.cfg
        dev = cfg.grid.device
        (mp, kp), (_, np_) = plan.padded_shapes
        with span("api.pad", device=dev):
            b_loc = sm.local_tile(_pad_to_shape(b, (kp, np_)), cfg)
        if plan.local_impl != "ranksparse":
            # the factor layout does not fit this grid: densify and run the
            # planned masked DAG (mask-level pruning only); B is promoted
            # to the factors' type, as JAX promotes the mixed product
            with span("api.pad", device=dev):
                a = torch.from_numpy(a_ranks.to_dense())
                b_loc = b_loc.to(torch.promote_types(a.dtype, b_loc.dtype))
                a_loc = sm.local_tile(_pad_to_shape(a, (mp, kp)), cfg)
            c_loc = sm.execute_plan(a_loc, b_loc, plan, compiled=compiled)
        else:
            u_all, v_all = sm.rank_operands(a_ranks, plan)
            with span("rank.upload", device=dev):
                u_loc = sm.local_tile(torch.from_numpy(u_all), cfg)
                v_loc = sm.local_tile(torch.from_numpy(v_all), cfg)
            c_loc = sm.execute_rank_plan(u_loc, v_loc, b_loc, plan,
                                         compiled=compiled)
            del u_loc, v_loc
        del b_loc
        with span("api.crop", device=dev):
            return sm.gather_tiles(c_loc, cfg)[:a_ranks.shape[0], :b.shape[1]]

    # -- tensor contractions -------------------------------------------------

    def contract(self, spec: str, x, y, **kwargs):
        """Einsum-style binary block-sparse tensor contraction: a delegate
        to :func:`core.contract.contract` with this instance supplying the
        grid, strategy, plan cache and the contraction caches."""
        from repro_torch.core.contract import contract as _contract

        return _contract(spec, x, y, mm=self, **kwargs)

    def contract_chain(self, steps, **kwargs):
        """Jointly scheduled chain of contractions
        (:func:`core.contract.contract_chain`)."""
        from repro_torch.core.contract import contract_chain as _chain

        return _chain(steps, mm=self, **kwargs)


@dataclasses.dataclass
class NonuniformMatmul:
    """Matmul over *nonuniformly blocked* matrices (paper §4.1/§4.4).

    Logical nonuniform tilings are bucketed into uniform physical tiles
    (``core.blocking.bucketize``); operands are gathered into the padded
    physical layout (zeros in the pad), multiplied through the wrapped
    ``DistributedMatmul``, and the result is gathered back to the compact
    layout.  Zero padding is exact: pad rows/cols contribute nothing.
    The gathers run on the operands' device; ``padding_waste`` quantifies
    the cost of the adaptation.

    ``tile="auto"`` takes the physical tile from the kernel autotune cache
    (``kernels.autotune.preferred_tile``): the measured-fastest square
    bucket, per FLOP, that the logical blocks can fill; 256 on a cold
    cache.  A cache measured on another kind of device than the grid's
    is refused.
    """

    mm: DistributedMatmul
    row_tiling: bk.Tiling
    inner_tiling: bk.Tiling
    col_tiling: bk.Tiling
    tile: int | str = 256

    def __post_init__(self):
        if self.tile == "auto":
            from repro_torch.kernels.autotune import preferred_tile

            max_block = max(
                max(self.row_tiling.sizes),
                max(self.inner_tiling.sizes),
                max(self.col_tiling.sizes),
            )
            self.tile = (
                preferred_tile(max_block, device=self.mm.grid.device) or 256
            )
        self.row_b = bk.bucketize(self.row_tiling, self.tile)
        self.inner_b = bk.bucketize(self.inner_tiling, self.tile)
        self.col_b = bk.bucketize(self.col_tiling, self.tile)

    @property
    def padding_waste(self) -> dict[str, float]:
        return {
            "rows": self.row_b.padding_waste,
            "inner": self.inner_b.padding_waste,
            "cols": self.col_b.padding_waste,
        }

    def plan(
        self,
        *,
        a_ranks: np.ndarray | None = None,
        itemsize: int = 4,
        lookahead: int | None = None,
        tune: bool = False,
    ) -> MatmulPlan:
        """The underlying uniform-tile plan for the bucketized product.

        ``a_ranks`` is a *logical* (row_blocks, inner_blocks) per-block
        rank map; see :meth:`physical_rank_map`.
        """
        return self.mm.plan(
            self.row_b.padded_extent,
            self.inner_b.padded_extent,
            self.col_b.padded_extent,
            a_ranks=(
                self.physical_rank_map(a_ranks)
                if a_ranks is not None else None
            ),
            itemsize=itemsize,
            lookahead=lookahead,
            tune=tune,
        )

    def physical_rank_map(self, logical_ranks: np.ndarray) -> BlockRankMap:
        """Expand a logical per-block rank map onto the physical tile grid.

        Every physical tile inherits its logical block's rank, clamped by
        the tile's valid extents (a submatrix cannot exceed its parent
        block's rank, nor its own dimensions).  Rank 0 means the logical
        block is screened out — its tiles are pruned like masked blocks.
        """
        ranks = np.asarray(logical_ranks, dtype=np.int32)
        want = (self.row_tiling.num_blocks, self.inner_tiling.num_blocks)
        if ranks.shape != want:
            raise ValueError(
                f"logical rank map {ranks.shape} must match the logical "
                f"block grid {want}"
            )
        bid_r = np.asarray(self.row_b.block_id)
        bid_i = np.asarray(self.inner_b.block_id)
        valid_r = np.asarray(self.row_b.valid)
        valid_i = np.asarray(self.inner_b.valid)
        phys = ranks[np.ix_(bid_r, bid_i)]
        cap = np.minimum(valid_r[:, None], valid_i[None, :])
        return BlockRankMap(
            ranks=np.minimum(phys, cap).astype(np.int32),
            bm=self.tile,
            bk=self.tile,
        )

    def _expand(self, x: torch.Tensor, bdim: bk.BucketedTiling, axis: int):
        """``x`` gathered along ``axis`` into the padded physical layout
        (one gather, then the pad zeroed in place)."""
        with span("blocking.expand", device=x.device):
            idx = torch.as_tensor(bdim.gather_indices(), device=x.device)
            out = x.index_select(axis, idx.clamp(min=0))
            pad = (idx < 0).nonzero().flatten()
            out.index_fill_(axis, pad, 0)
            return out

    def _compact(self, c: torch.Tensor) -> torch.Tensor:
        with span("blocking.compact", device=c.device):
            ridx = self.row_b.gather_indices()
            cidx = self.col_b.gather_indices()
            rsel = torch.as_tensor(np.nonzero(ridx >= 0)[0], device=c.device)
            csel = torch.as_tensor(np.nonzero(cidx >= 0)[0], device=c.device)
            # physical order of valid elements == logical order (blocks
            # packed in order, tiles in order within a block)
            return c.index_select(0, rsel).index_select(1, csel)

    def __call__(
        self,
        a,
        b,
        *,
        a_ranks: np.ndarray | None = None,
        lookahead: int | None = None,
        tune: bool = False,
    ) -> torch.Tensor:
        """C = A @ B for compact operands of the logical tilings' extents.
        ``a_ranks`` (logical per-block rank map) plans A's physical tiles
        rank-sparse: rank-0 logical blocks are screened out of the product
        and the plan's costs/schedule follow the tile ranks."""
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if tuple(a.shape) != (self.row_tiling.extent, self.inner_tiling.extent):
            raise ValueError(f"A shape {tuple(a.shape)} mismatches tilings")
        if tuple(b.shape) != (self.inner_tiling.extent, self.col_tiling.extent):
            raise ValueError(f"B shape {tuple(b.shape)} mismatches tilings")
        with span(ROOT, device=self.mm.grid.device):
            plan = self.plan(a_ranks=a_ranks, itemsize=a.element_size(),
                             lookahead=lookahead, tune=tune)
            return self._run(a, b, plan, compiled=self.mm.compiled)

    def _run(self, a, b, plan: MatmulPlan, *, compiled: bool) -> torch.Tensor:
        """C = A @ B under the physical plan ``plan``: expand, multiply,
        compact."""
        a_p = self._expand(self._expand(a, self.row_b, 0), self.inner_b, 1)
        b_p = self._expand(self._expand(b, self.inner_b, 0), self.col_b, 1)
        c_p = self.mm._run(a_p, b_p, plan, compiled=compiled)
        del a_p, b_p
        return self._compact(c_p)
