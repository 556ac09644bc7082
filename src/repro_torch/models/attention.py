"""GQA multi-head attention with RoPE, causal + sliding window.

The port of ``repro.models.attention``.  ``use_kernel=True`` runs the
hand-written flash-attention CUDA kernel through ``kernels.ops`` (the
plain version on CPU tensors); otherwise attention is the plain PyTorch
version, which materialises the fp32 scores, or, with
``ctx.attention_impl == "chunked"``, ``models.chunked_attention`` (the
training route: tiled, with its own backward).  M-RoPE (``cfg.rope == "mrope"``) takes positions
of shape (B, S, 3).

On a sharded model (``dist.partitioning.shard_params``) each rank runs
its q heads where ``wq``'s stored columns split them over tp (the
reference's constraint on q), its kv heads where ``num_kv_heads >=
tp`` splits them too, and otherwise the whole kv projection, of which it
keeps the heads its own q heads read.  ``wo`` is gathered to the rows of
those heads, and the partial outputs are summed over tp.  Where the
heads do not divide tp, every rank runs them all.
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


def _heads(p: Attention, cfg: ModelConfig, ctx: ParallelCtx):
    """This rank's head layout: ``(q sharded, kv sharded, kv heads its q
    heads read or None)``.  ``kv`` lists, for a rank whose q heads are
    split but kv heads whole, the kv heads it keeps: one per GQA group of
    its q heads where they fall into whole groups, else one per q head."""
    tp = ctx.tp_size
    hq = ctx.tp_sharded(p.wq.w, 1) and cfg.num_heads % tp == 0
    hkv = (hq and cfg.num_kv_heads >= tp and cfg.num_kv_heads % tp == 0
           and ctx.tp_sharded(p.wk.w, 1))
    if not hq or hkv:
        return hq, hkv, None
    q0, n = ctx.tp_part(cfg.num_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    kv = [(q0 + i) // group for i in range(n)]
    uniq = sorted(set(kv))
    if n % len(uniq) == 0 and kv == [u for u in uniq
                                     for _ in range(n // len(uniq))]:
        kv = uniq
    return hq, hkv, kv


def _linear(x, w, b=None):
    y = torch.matmul(x, w)
    return y if b is None else y + b


def _dense(p: L.Dense, x, ctx: ParallelCtx, *, tp_dim=None, partial=False):
    """``L.dense`` with the weights this rank computes with."""
    b = None if p.b is None else ctx.weight(
        p.b, tp_dim=None if tp_dim is None else 0, partial=partial)
    return _linear(x, ctx.weight(p.w, tp_dim=tp_dim, partial=partial), b)


def _project_qkv(p: Attention, x, positions, cfg: ModelConfig,
                 ctx: ParallelCtx, *, whole_kv: bool = False):
    """q, k, v (B, S, heads, Dh) on this rank's heads (``_heads``), after
    RoPE; ``x`` enters the tensor-parallel region here.  With
    ``whole_kv`` also k and v of every kv head (a split pair gathered
    over tp, outside autograd), for a serving cache."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv, kv = _heads(p, cfg, ctx)
    x = ctx.tp_enter(x, hq)
    q = _dense(p.wq, x, ctx, tp_dim=1 if hq else None).reshape(b, s, -1, hd)
    kcol = 1 if hkv else None
    k = _dense(p.wk, x, ctx, tp_dim=kcol, partial=hq).reshape(b, s, -1, hd)
    v = _dense(p.wv, x, ctx, tp_dim=kcol, partial=hq).reshape(b, s, -1, hd)
    q = ctx.wsc(q, ctx.dp, None, ctx.tp_axis, None)
    if cfg.rope == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = L.apply_mrope(q, positions, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.rope_theta)
    kc, vc = k, v
    if hkv and whole_kv:
        with torch.no_grad():
            kc, vc = (ctx.grid.all_gather(z, ctx.tp_axis, 2) for z in (k, v))
    if kv is not None:
        idx = torch.tensor(kv, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return (q, k, v, kc, vc) if whole_kv else (q, k, v)


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
    """Self-attention sublayer (pre-norm, residual added by caller).  With
    ``return_kv`` also the post-RoPE k and v (B, Hkv, S, Dh) of every kv
    head."""
    h = L.rmsnorm(p.norm, x, cfg.norm_eps)
    q, k, v, *whole = _project_qkv(p, h, positions, cfg, ctx,
                                   whole_kv=return_kv)
    hq = _heads(p, cfg, ctx)[0]
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
    if hq:  # the heads' partial outputs summed over tp in fp32
        o = L.matmul_f32(o, ctx.weight(p.wo.w, tp_dim=0))
        o = ctx.tp_exit(o, True).to(x.dtype)
    else:
        o = _linear(o, ctx.weight(p.wo.w))
    o = ctx.wsc(o, ctx.dp, None, None)
    if return_kv:
        kc, vc = whole  # post-RoPE, every kv head: (B, Hkv, S, Dh)
        return o, (kc.transpose(1, 2), vc.transpose(1, 2))
    return o
