"""Dense FFN sublayers: SwiGLU / GeGLU / GELU-MLP.

The port of ``repro.models.ffn``.  The big matmuls go through
``dist.collective_matmul.project``, so with ``matmul_strategy="summa"``
they run on the task-based SUMMA engine — the paper's algorithm embedded
in the LM.  Block masks registered in ``ctx.weight_block_masks`` flow
through each projection.
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
    return project(hidden, p.w_down.w, ctx)
