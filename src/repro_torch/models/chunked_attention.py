"""Flash-style chunked attention with its own backward — differentiable,
and no S x S materialization in either pass.

The port of ``repro.models.chunked_attention``.  The plain attention
(``kernels.flash_attention.flash_attention_plain``) writes (B, H, S, S)
fp32 scores, and autograd keeps them for the backward.  This version
tiles the computation into (Cq x Ck) blocks: the forward is an
online-softmax sweep, the backward recomputes probability tiles (flash
attention's recomputation).  Only q/k/v/o/do and the (B, H, S) row
statistics persist between the passes.  Causal block skipping drops
about half the tile work.

``chunked_attention`` is a ``torch.autograd.Function`` whose forward is
the reference's ``_fwd`` and whose backward is its ``_chunked_core_bwd``,
in torch ops over fp32 tiles: the same tiling (chunk sizes halved until
they divide S), the same causal range ``kj_hi`` and window range
``kj_lo``, masked logits at ``_NEG`` (not ``-inf``: a q-row's first
k-tile may lie wholly outside the window, and ``-inf - -inf`` would give
NaN where the reference's running maximum corrects itself), ``l_safe``,
``delta = (do·o).sum(-1)``, and dK and dV summed over each GQA group.
The reference's ``lax.scan`` over k-tiles is a Python loop here.
"""
from __future__ import annotations

import math

import torch

__all__ = ["chunked_attention"]

_NEG = -1e30


def _tile_logits(q_i, k_j, scale, causal, window, q0, k0, cq, ck):
    """(B, Hkv, G, Cq, Ck) masked logit tile."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q_i.float() * scale, k_j.float())
    pos_q = q0 + torch.arange(cq, device=s.device)[:, None]
    pos_k = k0 + torch.arange(ck, device=s.device)[None, :]
    mask = torch.ones((cq, ck), dtype=torch.bool, device=s.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    return torch.where(mask, s, _NEG)


def _k_range(q0, cq, ck, nk, causal, window) -> range:
    """The k-tiles a q-tile at ``q0`` visits."""
    kj_hi = nk if not causal else (q0 + cq + ck - 1) // ck
    kj_lo = 0 if window is None else max(0, (q0 - window) // ck)
    return range(kj_lo, kj_hi)


def _fwd(q, k, v, scale, causal, window, cq, ck):
    """Returns (o fp32, m, l) with shapes (B,Hkv,G,S,D), (B,Hkv,G,S)."""
    b, hkv, g, s, d = q.shape
    nk = s // ck
    dev = q.device
    o = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=dev)
    m_all = torch.full((b, hkv, g, s), _NEG, dtype=torch.float32, device=dev)
    l_all = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    for q0 in range(0, s, cq):
        q_i = q[:, :, :, q0:q0 + cq]
        m = torch.full((b, hkv, g, cq), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, d), dtype=torch.float32, device=dev)
        for kj in _k_range(q0, cq, ck, nk, causal, window):
            k0 = kj * ck
            st = _tile_logits(q_i, k[:, :, k0:k0 + ck], scale, causal, window,
                              q0, k0, cq, ck)
            m_new = torch.maximum(m, st.amax(-1))
            p = torch.exp(st - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, v[:, :, k0:k0 + ck].float())
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[:, :, :, q0:q0 + cq] = acc / l_safe[..., None]
        m_all[:, :, :, q0:q0 + cq] = m
        l_all[:, :, :, q0:q0 + cq] = l_safe
    return o, m_all, l_all


def _bwd(q, k, v, o, m, l, do, scale, causal, window, cq, ck):
    """(dq, dk, dv) in fp32: the reference's ``_chunked_core_bwd``."""
    b, hkv, g, s, d = q.shape
    nk = s // ck
    do = do.float()
    delta = (do * o).sum(-1)  # (B,Hkv,G,S)
    dq = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, cq):
        rows = slice(q0, q0 + cq)
        q_i = q[:, :, :, rows].float()
        do_i = do[:, :, :, rows]
        m_i, l_i, dl_i = m[..., rows], l[..., rows], delta[..., rows]
        dq_i = torch.zeros((b, hkv, g, cq, d), dtype=torch.float32,
                           device=q.device)
        for kj in _k_range(q0, cq, ck, nk, causal, window):
            k0 = kj * ck
            cols = slice(k0, k0 + ck)
            k_j, v_j = k[:, :, cols].float(), v[:, :, cols].float()
            st = _tile_logits(q_i, k_j, scale, causal, window, q0, k0, cq, ck)
            p = torch.exp(st - m_i[..., None]) / l_i[..., None]
            dv[:, :, cols] += torch.einsum("bhgqk,bhgqd->bhkd", p, do_i)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_i, v_j)
            ds = p * (dp - dl_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_j)
            dk[:, :, cols] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_i)
        dq[:, :, :, rows] = dq_i
    return dq, dk, dv


class _ChunkedCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, cq, ck):
        o, m, l = _fwd(q, k, v, scale, causal, window, cq, ck)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.args = (scale, causal, window, cq, ck)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, m, l, do, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def chunked_attention(
    q: torch.Tensor,  # (B, H, S, Dh)
    k: torch.Tensor,  # (B, Hkv, S, Dh)
    v: torch.Tensor,  # (B, Hkv, S, Dh)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    chunk_q: int = 512,
    chunk_k: int = 512,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Drop-in replacement for ``flash_attention_plain``, differentiable,
    O(S) memory in the sequence dimension."""
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    g = h // hkv
    cq = min(chunk_q, s)
    ck = min(chunk_k, s)
    while s % cq:
        cq //= 2
    while s % ck:
        ck //= 2
    scale_val = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hkv, g, s, dh)
    o = _ChunkedCore.apply(qg, k, v, scale_val, causal, window, cq, ck)
    return o.reshape(b, h, s, dh).to(out_dtype or q.dtype)
