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
* ``"auto"`` — the schedule tuner's per-shape pick, not ported (ROADMAP
  A1): raises.

``project`` also accepts an optional block mask over the weight
(``w_mask``, or one registered in ``ctx.weight_block_masks``): the
planned schedule then prunes dead K panels; the xla path zeroes masked
blocks so every strategy computes the same masked product.  All
strategies accumulate in fp32 and return the activation dtype, so
swapping them changes only the schedule, not the arithmetic contract.
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
        return matmul_f32(x, w).to(x.dtype)
    strategy = ctx.matmul_strategy
    if strategy == "auto":
        raise NotImplementedError(
            "matmul_strategy='auto' needs the schedule tuner (repro.sched), "
            "which is not ported yet (ROADMAP A1)"
        )
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if strategy == "allgather" and w_mask is None and _ring_eligible(
        ctx, x2, w
    ):
        raise NotImplementedError(
            "the tp > 1 ring collective matmul (allgather_matmul) is not "
            "ported yet (ROADMAP A8)"
        )
    out = ctx.matmul()(
        x2, w, b_mask=w_mask, strategy=None if strategy == "summa" else strategy
    )
    return out.reshape(*lead, w.shape[-1])
