"""Collective matmuls: the paper's engine embedded in the LM stack.

The port of ``repro.dist.collective_matmul``.  ``project`` is the single
entry point the model code uses for its big projections (models/ffn.py).
It routes by ``ctx.matmul_strategy``:

* ``"xla"`` — one ``torch.matmul`` (the reference's einsum).  The default,
  and the route of every context without a grid.
* ``"summa"`` — the task-based multiple-issue SUMMA schedule
  (core.summa, paper §3.2) over the (dp x tp) grid, via the
  ``DistributedMatmul`` built by ``ctx.matmul()``.
* ``"allgather"`` — the engine's all-gather strategy (the ``I = K``
  endpoint of Eq. (1)).  The reference runs a ring collective matmul
  over the TP axis instead when tp > 1 and no mask is given
  (``allgather_matmul``); that ring is not ported (ROADMAP A8) and
  raises.
* ``"auto"`` — per-shape pick by *simulated time*: the schedule tuner
  (``sched.tuner``) searches lookahead x k_blocks x strategy over the
  discrete-event simulator and the engine executes the winner.  Where
  the ring is eligible (tp > 1) and its pipeline estimate
  (``ring_makespan``) beats the tuned makespan, the reference runs the
  ring; here that raises (ROADMAP A8).

``project`` also accepts an optional block mask over the weight
(``w_mask``, or one registered in ``ctx.weight_block_masks``): the
planned schedule then prunes dead K panels; the xla path zeroes masked
blocks so every strategy computes the same masked product.  All
strategies accumulate in fp32 and return the activation dtype, so
swapping them changes only the schedule, not the arithmetic contract.

Gradients.  The xla route differentiates through ``matmul_f32``.  The
engine routes run as ``_EngineMatmul``, an autograd Function whose
backward runs two more engine products with the same schedule: dX =
dY·Wᵀ (under Wᵀ's block mask) and dW = Xᵀ·dY (the weight's masked
blocks zeroed), so the paper's algorithm runs in the backward too, as the
reference's autodiff of its ``shard_map`` program does.  Autograd never
traces the executors (their in-place accumulation and the ``Grid``
collectives are not autograd-aware): every rank holds whole operands,
runs the same products and so gets the whole gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.summa import _apply_block_mask
from repro_torch.models.layers import matmul_f32

__all__ = ["project"]


def _mask_weight(w: torch.Tensor, w_mask: np.ndarray) -> torch.Tensor:
    """Zero masked blocks of a (d_in, d_out) weight (einsum-path parity)."""
    return _apply_block_mask(w, np.asarray(w_mask, dtype=bool))


def _ring_eligible(ctx, x2: torch.Tensor, w: torch.Tensor) -> bool:
    return (
        ctx.tp_size > 1
        and x2.shape[0] % (ctx.dp_size * ctx.tp_size) == 0
        and w.shape[-1] % ctx.tp_size == 0
    )


class _EngineMatmul(torch.autograd.Function):
    """``mm(x2, w)`` on the engine, with an engine backward."""

    @staticmethod
    def forward(ctx, x2, w, mm, w_mask, strategy, tune):
        ctx.save_for_backward(x2, w)
        ctx.route = (mm, w_mask, strategy, tune)
        return mm(x2, w, b_mask=w_mask, strategy=strategy, tune=tune)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        mm, w_mask, strategy, tune = ctx.route
        dy = dy.to(x2.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt_mask = None if w_mask is None else np.asarray(w_mask).T
            dx = mm(dy, w.t().contiguous(), b_mask=wt_mask,
                    strategy=strategy, tune=tune)
        if ctx.needs_input_grad[1]:
            dw = mm(x2.t().contiguous(), dy, strategy=strategy, tune=tune)
            if w_mask is not None:
                dw = _mask_weight(dw, w_mask)
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None


def project(
    x: torch.Tensor,
    w: torch.Tensor,
    ctx,
    *,
    w_mask: np.ndarray | None = None,
) -> torch.Tensor:
    """``x @ w`` with the context's matmul strategy.

    ``x``: (..., d_in) activations; ``w``: (d_in, d_out) kernel.  Leading
    dims are flattened into SUMMA's M dimension and restored afterwards.
    ``w_mask`` is an optional (Kblk, Nblk) block mask over the weight;
    when omitted, ``ctx.weight_block_masks`` is consulted for the weight
    shape.  Contexts without a grid always take the matmul path.
    """
    if w_mask is None:
        w_mask = ctx.weight_mask(w.shape)
    if ctx.matmul_strategy == "xla" or not ctx.has_grid or ctx.pure_dp:
        if w_mask is not None:
            w = _mask_weight(w, w_mask)
        return matmul_f32(x, w, out_dtype=x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    strategy = ctx.matmul_strategy
    ring_ok = _ring_eligible(ctx, x2, w)
    tune = False
    if strategy == "auto":
        if w_mask is not None:
            # Masked plans always execute the planned broadcast schedule
            # (DAG or BSMM); the tuner still picks the lookahead window.
            strategy = "summa"
            tune = True
        else:
            # One cached tuned plan per shape: the simulator-searched
            # schedule, vs. the ring's pipeline estimate where the ring
            # is eligible.
            from repro_torch.sched.tuner import ring_makespan

            plan = ctx.matmul().plan(
                x2.shape[0], x2.shape[1], w.shape[1],
                itemsize=x2.element_size(), tune=True,
            )
            if ring_ok and ring_makespan(plan) < plan.tuned["makespan_s"]:
                strategy = "ring"
            else:
                strategy = "summa"
                tune = True
    if strategy in ("allgather", "ring") and ring_ok and w_mask is None:
        raise NotImplementedError(
            "the tp > 1 ring collective matmul (allgather_matmul) is not "
            "ported yet (ROADMAP A8)"
        )
    summa_strategy = None if strategy == "summa" else strategy
    out = _EngineMatmul.apply(x2, w, ctx.matmul(), w_mask, summa_strategy,
                              tune)
    return out.reshape(*lead, w.shape[-1])
