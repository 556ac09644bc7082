"""GQA multi-head attention with RoPE, causal + sliding window.

The port of ``repro.models.attention``.  ``use_kernel=True`` runs the
hand-written flash-attention CUDA kernel through ``kernels.ops`` (the
plain version on CPU tensors); otherwise attention is the plain PyTorch
version, which materialises the fp32 scores, or, with
``ctx.attention_impl == "chunked"``, ``models.chunked_attention`` (the
training route: tiled, with its own backward).  M-RoPE (``cfg.rope == "mrope"``) takes positions
of shape (B, S, 3).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.context import ParallelCtx
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as L
from repro_torch.models.chunked_attention import chunked_attention
from repro_torch.models.config import ModelConfig

__all__ = ["Attention", "attention", "init_attention"]


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and the pre-norm ``norm``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        d = cfg.d_model
        hd = cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = L.Dense(d, cfg.num_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = L.Dense(d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = L.Dense(d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = L.Dense(cfg.num_heads * hd, d, bias=False, **kw)
        self.norm = L.RMSNorm(d, device=device)


def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   dtype=torch.bfloat16, device="cuda") -> Attention:
    return L.init_params(Attention(cfg, dtype=dtype, device=device),
                         generator)


def _project_qkv(p: Attention, x, positions, cfg: ModelConfig,
                 ctx: ParallelCtx):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(p.wq, x).reshape(b, s, cfg.num_heads, hd)
    k = L.dense(p.wk, x).reshape(b, s, cfg.num_kv_heads, hd)
    v = L.dense(p.wv, x).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.rope == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = L.apply_mrope(q, positions, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(
    p: Attention,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) or (B, S, 3) for mrope
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    window: int | None = None,
    use_kernel: bool = False,
    return_kv: bool = False,
):
    """Self-attention sublayer (pre-norm, residual added by caller)."""
    h = L.rmsnorm(p.norm, x, cfg.norm_eps)
    q, k, v = _project_qkv(p, h, positions, cfg, ctx)
    # (B, S, H, Dh) -> (B, H, S, Dh): views, which the kernel reads in place
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    if use_kernel:
        o = kops.flash_attention(qt, kt, vt, causal=cfg.causal, window=window)
    elif ctx.attention_impl == "chunked":
        o = chunked_attention(qt, kt, vt, causal=cfg.causal, window=window)
    else:
        o = flash_attention_plain(qt, kt, vt, causal=cfg.causal,
                                  window=window)
    b, s = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, s, -1)
    o = L.dense(p.wo, o)
    if return_kv:
        return o, (kt, vt)  # post-RoPE (B, Hkv, S, Dh)
    return o
