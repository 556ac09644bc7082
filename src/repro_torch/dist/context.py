"""ParallelCtx: the one object that carries parallelism policy.

The port of ``repro.dist.context``.  Every model entry point takes a
``ParallelCtx``.  It bundles the device grid with the axis roles (which
grid axis acts as data parallel, which as tensor parallel) and the
feature switches of the reference (matmul strategy, attention
implementation, mLSTM chunking, ZeRO-1 (``zero1``: parameters whole
over the FSDP axis, optimizer state sharded over it), int8 KV-cache
quantization for serving (``kv_quant``, read by ``serve.engine``),
sLSTM replication, pure data parallelism, static weight sparsity).
Model code never touches the grid directly; it goes through the
helpers below and ``repro_torch.dist.collective_matmul.project``.

The port holds a ``core.grid.Grid`` (or ``None``) where the reference
holds a ``Mesh``, and each rank runs its own program on its shards
(``dist.partitioning.shard_params``).  Where the reference constrains a
global array's sharding (``wsc``), the rank's tensor here *is* its
block under that constraint:

* ``block(x, *entries)`` cuts a tensor every rank holds whole to its
  block (the batch over dp where the forward takes its inputs); past
  that point every tensor of the rank's program has its constraint's
  layout by construction, so ``wsc`` marks the reference's sites and
  moves nothing;
* ``weight(p, tp_dim=...)`` gathers a stored parameter block to what
  the rank computes with (whole over the FSDP axis; over TP its shard of
  ``tp_dim``, the rank's heads, hidden columns, experts or vocab rows,
  and whole elsewhere), with the gradient each gather's transpose gives
  (``core.grid``'s autograd-aware collectives); ``whole(module)`` is
  a view of a module whose weights are all gathered whole, for the
  blocks every tp rank repeats (the recurrent ones, decode's
  projections);
* ``tp_enter`` / ``tp_exit`` open and close a tensor-parallel region:
  an activation whole over tp enters it (its gradient summed over tp)
  and the region's partial outputs leave it summed (``Grid.sum``);
* ``tp_part(n)`` is the rank's part of a dim of ``n`` over tp.

``matmul()`` wires the paper's engine into the LM stack: with
``matmul_strategy="summa"`` it builds a ``core.api.DistributedMatmul``
over the (dp x tp) grid running the task-based multiple-issue schedule,
and the FFN projections route through it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

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
    # sharded over it
    zero1: bool = False
    # serving caches hold K/V as int8 with per-(token, head) fp32 scales
    kv_quant: bool = False
    # sLSTM recurrence kept tp-replicated (its gate inputs whole over tp:
    # every rank's layout there anyway, so the flag changes no number)
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
        """The reference's sharding constraint at one of its sites: the
        rank's tensor ``x`` there already is its block under ``entries``
        (the batch cut by ``block`` at the forward's entry, heads, hidden
        columns and vocab by the stored shards), so ``x``."""
        del entries
        return x

    def block(self, x, *entries):
        """This rank's block of ``x``, which every rank holds whole, under
        ``entries`` (a dim that does not divide its axis group stays
        whole, as ``_validate_spec`` degrades it).  Without a grid,
        ``x``."""
        if not self.has_grid:
            return x
        from repro_torch.dist.partitioning import _validate_spec, block_of

        spec = _validate_spec(entries, tuple(x.shape), self.grid)
        if all(e is None for e in spec):
            return x
        return block_of(x, spec, self.grid)

    def splits_batch(self, n: int) -> bool:
        """Whether a batch of ``n`` rows is split over dp (it divides)."""
        return self.dp_size > 1 and n % self.dp_size == 0

    def tp_part(self, n: int) -> tuple[int, int]:
        """``(start, count)`` of this rank's part of a dim of ``n`` split
        over tp; the whole dim where tp is 1 or does not divide it."""
        tp = self.tp_size
        if tp == 1 or n % tp:
            return 0, n
        count = n // tp
        return self.grid.axis_index(self.tp_axis) * count, count

    def tp_sharded(self, p, dim: int) -> bool:
        """Whether the stored parameter ``p`` holds only this rank's part
        of ``dim`` over tp (its validated spec, never the proposed one)."""
        spec = getattr(p, "spec", None)
        return (self.tp_size > 1 and spec is not None
                and spec[dim] == self.tp_axis)

    def weight(self, p, *, tp_dim: int | None = None,
               partial: bool = False, repeat: bool = False):
        """What this rank computes with from the stored parameter ``p``
        (its block under ``p.spec``; a parameter without a spec is whole
        on every rank, replicated over every axis).

        A dim stored over the FSDP axis is gathered with
        ``Grid.fsdp_gather`` (its gradient the sum over the ranks' rows).
        Over tp, dim ``tp_dim`` becomes this rank's part (kept where
        stored so, cut by ``Grid.shard`` where stored whole) and every
        other dim stored over tp is gathered: by ``Grid.gather`` where the
        tp ranks repeat the computation, by ``Grid.fsdp_gather`` with
        ``partial`` (each tp rank uses the whole weight for a different
        part; a weight stored whole over tp then passes ``Grid.replicate``,
        its gradient summed over tp).  ``repeat`` gathers the FSDP axis by
        ``Grid.gather`` too, for a product every dp rank repeats on whole
        operands; there a weight replicated over dp axes takes 1/their
        size of the gradient.  The gradient of a parameter replicated over
        a dp axis is summed there after the backward
        (``train.train_step.sync_grads``)."""
        if not self.has_grid:
            return p
        grid = self.grid
        spec = getattr(p, "spec", None) or (None,) * p.ndim
        x = p
        if partial and self.tp_size > 1 and self.tp_axis not in spec:
            x = grid.replicate(x, self.tp_axis)
        for dim, entry in enumerate(spec):
            if (entry is None or grid.axis_size(entry) == 1
                    or (dim == tp_dim and entry == self.tp_axis)):
                continue
            if (entry == self.tp_axis and not partial) or repeat:
                x = grid.gather(x, entry, dim)
            else:
                x = grid.fsdp_gather(x, entry, dim)
        if (tp_dim is not None and self.tp_size > 1
                and not self.tp_sharded(p, tp_dim)):
            x = grid.shard(x, self.tp_axis, tp_dim)
        if repeat:
            n = math.prod(grid.shape[a] for a in self.dp_axes
                          if a not in spec)
            if n > 1:
                x = _GradScale.apply(x, 1.0 / n)
        return x

    def whole(self, module):
        """``module`` as the rank computes with it where the tp ranks
        repeat a computation: a view whose parameters are ``weight(p)``
        (whole, gathered once per view); ``module`` itself on a grid of
        one rank."""
        if not self.has_grid or math.prod(self.grid.sizes) == 1:
            return module
        return _Whole(module, self)

    def tp_enter(self, x, sharded: bool):
        """``x`` (whole over tp) entering a tensor-parallel region whose
        ranks split its uses (``sharded``): its gradient is summed over
        tp.  Otherwise ``x``."""
        if not sharded or self.tp_size == 1:
            return x
        return self.grid.replicate(x, self.tp_axis)

    def tp_exit(self, y, sharded: bool):
        """The partial outputs ``y`` of a tensor-parallel region summed
        over tp (``Grid.sum``), where the region is ``sharded``."""
        if not sharded or self.tp_size == 1:
            return y
        return self.grid.sum(y, self.tp_axis)

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


class _GradScale(torch.autograd.Function):
    """The identity, whose gradient is scaled by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


class _Whole:
    """``ParallelCtx.whole``'s view of a module: a parameter attribute
    reads as ``ctx.weight(p)`` (each gathered once), a submodule as its
    view, anything else as it is."""

    def __init__(self, module, ctx):
        self._module, self._ctx, self._seen = module, ctx, {}

    def __getattr__(self, name):
        if name in self._seen:
            return self._seen[name]
        value = getattr(self._module, name)
        if isinstance(value, nn.Parameter):
            value = self._ctx.weight(value)
        elif isinstance(value, nn.Module):
            value = _Whole(value, self._ctx)
        self._seen[name] = value
        return value
