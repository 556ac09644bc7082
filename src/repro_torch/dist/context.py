"""ParallelCtx: the one object that carries parallelism policy.

The port of ``repro.dist.context``.  Every model entry point takes a
``ParallelCtx``.  It bundles the device grid with the axis roles (which
grid axis acts as data parallel, which as tensor parallel) and the
feature switches of the reference (matmul strategy, attention
implementation, mLSTM chunking, ZeRO-1 (``zero1``, read by
``train.train_step``'s sharding specs; it changes no number), int8
KV-cache quantization for serving (``kv_quant``, read by
``serve.engine``), sLSTM replication, pure data parallelism, static
weight sparsity).  Model code never touches the grid directly; it goes
through ``ctx.wsc`` and ``repro_torch.dist.collective_matmul.project``.

The port holds a ``core.grid.Grid`` (or ``None``) where the reference
holds a ``Mesh``.  Activations are whole on every rank, so ``wsc`` (the
reference's sharding constraint) is the identity; the port's sharding
rules wait for ROADMAP A8b.  ``matmul()`` wires the paper's engine into
the LM stack: with ``matmul_strategy="summa"`` it builds a
``core.api.DistributedMatmul`` over the (dp x tp) grid running the
task-based multiple-issue schedule, and the FFN projections route
through it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.core.grid import Grid

__all__ = ["ParallelCtx"]

#: matmul_strategy -> core.summa strategy actually executed
_MATMUL_STRATEGIES = {
    "xla": None,  # plain torch.matmul (the reference's einsum)
    "summa": "taskbased",  # paper Eq. (1) multiple-issue SUMMA
    "allgather": "allgather",  # I = K endpoint of Eq. (1)
    # per-shape pick by the schedule tuner (repro_torch.sched.tuner)
    "auto": "taskbased",
}


@dataclasses.dataclass
class ParallelCtx:
    """Grid + axis roles + parallelism feature switches.

    ``dp_axes`` may name several axes (a two-pod grid ``("pod", "data",
    "model")``); the engine then runs SUMMA with their tuple as its row
    axis.  ``pure_dp=True`` folds the tensor-parallel axis into data
    parallelism: ``tp_axis`` becomes ``None``.
    """

    grid: Grid | None
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str | None = "model"
    matmul_strategy: str = "xla"  # "xla" | "summa" | "allgather" | "auto"
    attention_impl: str = "ref"  # "ref" | "chunked"
    # mLSTM blocks run the chunkwise form at this chunk length (None: the
    # quadratic parallel form over the whole sequence)
    mlstm_chunk: int | None = None
    # ZeRO-1: parameters replicated over the FSDP axis, optimizer state
    # sharded over it (spec tuples only: every rank holds whole tensors)
    zero1: bool = False
    # serving caches hold K/V as int8 with per-(token, head) fp32 scales
    kv_quant: bool = False
    # sLSTM recurrence kept tp-replicated (one sharding constraint, which
    # is the identity here: the flag changes no number)
    slstm_replicated: bool = False
    pure_dp: bool = False
    # Static block-sparsity of projection weights: maps (d_in, d_out) ->
    # bool block mask.  ``project`` consults it so sparse FFN weights run
    # the planned block-sparse schedule (and the xla path stays masked for
    # an identical arithmetic contract).
    weight_block_masks: Any = None

    def __post_init__(self):
        if isinstance(self.dp_axes, str):
            self.dp_axes = (self.dp_axes,)
        else:
            self.dp_axes = tuple(self.dp_axes)
        if self.matmul_strategy not in _MATMUL_STRATEGIES:
            raise ValueError(
                f"matmul_strategy={self.matmul_strategy!r}; "
                f"known: {sorted(_MATMUL_STRATEGIES)}"
            )
        # With pure DP there is no tensor-parallel axis: remember the raw
        # name for SUMMA grid construction but expose tp_axis=None.
        self._tp_axis_raw = self.tp_axis
        if self.pure_dp:
            self.tp_axis = None
        self._mm_cache = None

    # -- grid geometry -------------------------------------------------------

    @property
    def has_grid(self) -> bool:
        return self.grid is not None

    @property
    def dp(self):
        """The data-parallel axis entry (name or tuple of names)."""
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def dp_size(self) -> int:
        if not self.has_grid:
            return 1
        return math.prod(self.grid.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        if not self.has_grid or self.tp_axis is None:
            return 1
        return self.grid.shape[self.tp_axis]

    # -- sharding helpers ----------------------------------------------------

    def wsc(self, x, *entries):
        """The reference's sharding constraint: the identity, since every
        rank holds whole activations (sharding rules: ROADMAP A8b)."""
        del entries
        return x

    # -- static weight sparsity ----------------------------------------------

    def weight_mask(self, shape) -> Any:
        """Block mask registered for a (d_in, d_out) weight shape, if any."""
        if not self.weight_block_masks:
            return None
        return self.weight_block_masks.get(tuple(shape))

    # -- the paper's engine --------------------------------------------------

    def matmul(self) -> Any:
        """Factory: the ``core.api.DistributedMatmul`` realising this ctx's
        matmul strategy on the (dp x tp) grid.

        Cached — SUMMA configuration is static per context, so every FFN
        projection of the stack shares one engine and its plan cache.
        """
        if self._mm_cache is not None:
            return self._mm_cache
        if not self.has_grid:
            raise ValueError("matmul_strategy needs a grid; got grid=None")
        strategy = _MATMUL_STRATEGIES[self.matmul_strategy]
        if strategy is None:
            raise ValueError("matmul() is not used for the 'xla' strategy")
        if self._tp_axis_raw is None:
            raise ValueError("SUMMA needs a tensor-parallel grid axis")
        from repro_torch.core.api import DistributedMatmul  # no cycle

        self._mm_cache = DistributedMatmul(
            self.grid,
            row_axis=self.dp,
            col_axis=self._tp_axis_raw,
            strategy=strategy,
        )
        return self._mm_cache

    def plan_projection(
        self, m: int, d_in: int, d_out: int, *, itemsize=4, tune=False,
        stationarity: str = "C", strategy: str | None = None,
        lookahead: int | None = None, comm_mode: str = "broadcast",
        k_blocks: int | None = None,
    ):
        """Pre-build (and cache) the plan for an (m, d_in)x(d_in, d_out)
        projection, so the first forward finds it in the engine's plan
        cache.  No-op (``None``) on the xla path.  ``tune=True``
        additionally runs the schedule tuner (what the ``"auto"`` strategy
        executes).  ``stationarity`` forwards to the planner (``"auto"``
        lets the comm-volume model pick the A-/B-/C-stationary schedule).
        ``strategy`` / ``lookahead`` / ``comm_mode`` / ``k_blocks`` pin a
        previously tuned schedule explicitly.
        """
        if (
            not self.has_grid
            or self.matmul_strategy == "xla"
            or self.pure_dp
        ):
            return None
        return self.matmul().plan(
            m, d_in, d_out,
            b_mask=self.weight_mask((d_in, d_out)),
            itemsize=itemsize,
            tune=tune,
            stationarity=stationarity,
            strategy=strategy,
            lookahead=lookahead,
            comm_mode=comm_mode,
            k_blocks=k_blocks,
        )
