"""Dense FFN sublayers: SwiGLU / GeGLU / GELU-MLP.

The port of ``repro.models.ffn``.  The big matmuls go through
``dist.collective_matmul.project``, so with ``matmul_strategy="summa"``
they run on the task-based SUMMA engine — the paper's algorithm embedded
in the LM.  Block masks registered in ``ctx.weight_block_masks`` flow
through each projection.

On a sharded model the hidden dim is split over tp where ``w_up``'s
stored columns are (the reference's constraint on ``up``/``gate``):
each rank runs its hidden columns, ``w_down`` is gathered to the rows
of those columns, and the partial outputs are summed over tp
(``project(..., split_in=True)``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.collective_matmul import project
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

__all__ = ["FFN", "ffn", "init_ffn"]


class FFN(nn.Module):
    """``norm``, ``w_up``, ``w_down`` and, for the gated activations,
    ``w_gate``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.norm = L.RMSNorm(d, device=device)
        self.w_up = L.Dense(d, f, **kw)
        self.w_down = L.Dense(f, d, **kw)
        self.w_gate = (L.Dense(d, f, **kw)
                       if cfg.activation in ("swiglu", "geglu") else None)


def init_ffn(cfg: ModelConfig, *, generator: torch.Generator,
             dtype=torch.bfloat16, device="cuda") -> FFN:
    return L.init_params(FFN(cfg, dtype=dtype, device=device), generator)


def ffn(p: FFN, x: torch.Tensor, cfg: ModelConfig,
        ctx: ParallelCtx) -> torch.Tensor:
    h = L.rmsnorm(p.norm, x, cfg.norm_eps)
    act = L.ACTIVATIONS[cfg.activation]
    # project() resolves ctx.weight_block_masks per weight shape itself.
    up = project(h, p.w_up.w, ctx)
    if p.w_gate is not None:
        hidden = act(project(h, p.w_gate.w, ctx)) * up
    else:
        hidden = act(up)
    del up
    hidden = ctx.wsc(hidden, ctx.dp, None, ctx.tp_axis)
    out = project(hidden, p.w_down.w, ctx,
                  split_in=ctx.tp_sharded(p.w_up.w, 1))
    return ctx.wsc(out, ctx.dp, None, None)
