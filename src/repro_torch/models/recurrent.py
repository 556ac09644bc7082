"""Recurrent blocks: RG-LRU (RecurrentGemma), mLSTM and sLSTM (xLSTM).

The port of ``repro.models.recurrent``.  The sequence forms are the
reference's parallel ones: the RG-LRU diagonal linear recurrence is an
associative scan (``associative_scan``: the odd/even recursion of
``jax.lax.associative_scan`` in plain torch ops, log-depth in S, so it
keeps the reference's order of combines); the mLSTM matrix memory is the
stabilized quadratic (attention-like) form of the xLSTM paper, or its
chunkwise form when ``ctx.mlstm_chunk`` is set; the sLSTM has a
recurrent nonlinearity and runs as a Python loop over S, one cell per
token (the reference's ``lax.scan``).

Each block also has the serving path's pieces: ``return_state=True``
gives the state after the sequence, ``*_init_state`` an empty one and
``*_step`` advances it by one token.  Recurrent state is O(1) in the
sequence length.

Parameters live in ``RGLRUBlock``, ``MLSTMBlock`` and ``SLSTMBlock``,
named as the reference's dictionary keys; the RG-LRU's ``lambda`` (a
Python keyword) is registered by name and read with ``getattr``.
Precision follows the reference op by op: projections in the model's
dtype, gates, scans and memories in fp32, the depthwise convolution of
the sequence path summed tap by tap in the input's dtype (its ``*_step``
path sums in fp32, as the reference's does).

On a sharded model every tp rank runs the whole block on its batch rows
(the reference constrains only the batch, over dp): a block reads its
weights through ``ParallelCtx.whole``, gathered whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.analysis import cost
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

__all__ = [
    "MLSTMBlock", "RGLRUBlock", "SLSTMBlock", "associative_scan",
    "init_mlstm_block", "init_rglru_block", "init_slstm_block",
    "mlstm_block", "mlstm_init_state", "mlstm_step", "rglru_block",
    "rglru_init_lambda", "rglru_init_state", "rglru_step", "slstm_block",
    "slstm_init_state", "slstm_step",
]

_RGLRU_C = 8.0
_CONV_TAPS = 4


def _reset_conv(w: nn.Parameter, b: nn.Parameter, generator) -> None:
    """``conv_w`` N(0, 1)·0.1 drawn in fp32 and cast; ``conv_b`` zero."""
    x = torch.randn(w.shape, generator=generator, device=w.device,
                    dtype=torch.float32)
    w.data.copy_(x * 0.1)
    b.data.zero_()


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S; x (B, S, C), w (K, C).  The taps are
    summed one after another in x's dtype (each add rounds), as the
    reference's Python ``sum``."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out + b


def _conv_history(u: torch.Tensor) -> torch.Tensor:
    """The last K-1 inputs of (B, S, C) ``u`` in fp32, zero-padded in
    front when S < K-1: the conv state a ``*_step`` continues from."""
    b, s, c = u.shape
    pad = torch.zeros((b, max(0, _CONV_TAPS - 1 - s), c),
                      dtype=torch.float32, device=u.device)
    return torch.cat([pad, u[:, max(0, s - (_CONV_TAPS - 1)):, :].float()],
                     dim=1)


def _conv_step(hist: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One output of the conv from the (B, K, C) fp32 history, in fp32."""
    return (hist * w.float()[None]).sum(1) + b.float()


# -- the associative scan ----------------------------------------------------


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... of dim 1."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the linear recurrence's pairs under
    ``(a1, b1) . (a2, b2) = (a1·a2, a2·b1 + b2)``: returns (A, Y) with
    ``Y_t = a_t·Y_{t-1} + b_t``.  The odd/even recursion of
    ``jax.lax.associative_scan``, so every element is combined in the
    reference's order; about 2·log2(S) rounds of elementwise ops."""
    n = a.shape[1]
    if n < 2:
        return a, b
    reduced = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    odd = associative_scan(*reduced)
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


# =========================== RG-LRU block ===================================


def rglru_init_lambda(width: int) -> torch.Tensor:
    """Λ, so that a = exp(-c·softplus(Λ)) spreads over (0.9, 0.999): the
    reference's ``log(expm1(-log(linspace(0.9, 0.999)) / c))`` in fp32,
    with ``jnp.linspace``'s formula (start·(1 - t) + stop·t, t = i/(n-1),
    the last point ``stop``), on the CPU."""
    start = torch.tensor(0.9, dtype=torch.float32)
    stop = torch.tensor(0.999, dtype=torch.float32)
    if width > 1:
        div = width - 1
        t = torch.arange(div, dtype=torch.float32) / torch.tensor(
            float(div), dtype=torch.float32)
        ramp = torch.cat([start * (1 - t) + stop * t, stop[None]])
    else:
        ramp = start.reshape(width)
    return torch.log(torch.expm1(-torch.log(ramp) / _RGLRU_C))


class RGLRUBlock(nn.Module):
    """``norm``, ``w_x``, ``w_gate``, ``conv_w`` (4, Dr), ``conv_b``,
    ``w_input_gate``, ``w_rec_gate``, ``lambda`` (Dr,) fp32 and ``w_out``;
    the LRU width Dr is d_model."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        d = dr = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.norm = L.RMSNorm(d, device=device)
        self.w_x = L.Dense(d, dr, **kw)
        self.w_gate = L.Dense(d, dr, **kw)
        self.conv_w = L._param((_CONV_TAPS, dr), dtype, device)
        self.conv_b = L._param((dr,), dtype, device)
        self.w_input_gate = L.Dense(dr, dr, **kw)
        self.w_rec_gate = L.Dense(dr, dr, **kw)
        self.register_parameter("lambda",
                                L._param((dr,), torch.float32, device))
        self.w_out = L.Dense(dr, d, **kw)

    def reset_parameters(self, generator=None) -> None:
        """``conv_w``, ``conv_b`` and the deterministic ``lambda`` (the
        dense layers and the norm draw their own)."""
        _reset_conv(self.conv_w, self.conv_b, generator)
        lam = getattr(self, "lambda")
        lam.data.copy_(rglru_init_lambda(lam.shape[0]))


def init_rglru_block(cfg: ModelConfig, *, generator: torch.Generator,
                     dtype=torch.bfloat16, device="cuda") -> RGLRUBlock:
    return L.init_params(RGLRUBlock(cfg, dtype=dtype, device=device),
                         generator)


def _rglru_gates(p: RGLRUBlock, u: torch.Tensor):
    """Gate computations shared by scan and step paths; u (..., Dr)."""
    r = torch.sigmoid(L.dense(p.w_rec_gate, u).float())
    i = torch.sigmoid(L.dense(p.w_input_gate, u).float())
    log_a = -_RGLRU_C * F.softplus(getattr(p, "lambda")) * r  # fp32
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * u.float())
    return a, gated_in


def rglru_block(
    p: RGLRUBlock,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    return_state: bool = False,
):
    """(B, S, D) -> (B, S, D) recurrent sublayer (residual by caller)."""
    p = ctx.whole(p)  # the tp ranks repeat the block
    h = L.rmsnorm(p.norm, x, cfg.norm_eps)
    u_pre = L.dense(p.w_x, h)
    u = _causal_conv(u_pre, p.conv_w, p.conv_b)
    a, b = _rglru_gates(p, u)
    del u
    _, y = associative_scan(a, b)  # y_t = a_t * y_{t-1} + b_t
    del a, b
    gate = L.gelu(L.dense(p.w_gate, h).float())
    out = L.dense(p.w_out, (y * gate).to(x.dtype))
    out = ctx.wsc(out, ctx.dp, None, None)
    if return_state:
        return out, {"h": y[:, -1, :], "conv": _conv_history(u_pre)}
    return out


def rglru_init_state(p: RGLRUBlock, batch: int) -> dict:
    lam = getattr(p, "lambda")
    dr = lam.shape[0]
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=lam.device),
        # the last K-1 inputs
        "conv": torch.zeros((batch, _CONV_TAPS - 1, dr), dtype=torch.float32,
                            device=lam.device),
    }


def rglru_step(p: RGLRUBlock, x_t: torch.Tensor, state: dict,
               cfg: ModelConfig):
    """x_t (B, D) one token; returns (y_t, new_state)."""
    h = L.rmsnorm(p.norm, x_t, cfg.norm_eps)
    u = L.dense(p.w_x, h)
    hist = torch.cat([state["conv"], u[:, None, :].float()], dim=1)
    u_c = _conv_step(hist, p.conv_w, p.conv_b).to(u.dtype)
    a, b = _rglru_gates(p, u_c)
    y = a * state["h"] + b
    gate = L.gelu(L.dense(p.w_gate, h).float())
    out = L.dense(p.w_out, (y * gate).to(x_t.dtype))
    return out, {"h": y, "conv": hist[:, 1:, :]}


# ============================== mLSTM block =================================


class MLSTMBlock(nn.Module):
    """``norm``, ``w_in`` (D, 2·Di: x_m then the gate z), ``conv_w``,
    ``conv_b``, ``w_q``, ``w_k``, ``w_v``, ``w_if`` (Di, 2H: input then
    forget gates), ``head_norm`` (width Di/H) and ``w_out``; the inner
    width Di is 2·d_model."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        d = cfg.d_model
        di = 2 * d  # inner expansion 2x (xLSTM-1.3b default)
        kw = dict(dtype=dtype, device=device)
        self.norm = L.RMSNorm(d, device=device)
        self.w_in = L.Dense(d, 2 * di, **kw)
        self.conv_w = L._param((_CONV_TAPS, di), dtype, device)
        self.conv_b = L._param((di,), dtype, device)
        self.w_q = L.Dense(di, di, **kw)
        self.w_k = L.Dense(di, di, **kw)
        self.w_v = L.Dense(di, di, **kw)
        self.w_if = L.Dense(di, 2 * cfg.num_heads, **kw)
        self.head_norm = L.RMSNorm(di // cfg.num_heads, device=device)
        self.w_out = L.Dense(di, d, **kw)

    def reset_parameters(self, generator=None) -> None:
        _reset_conv(self.conv_w, self.conv_b, generator)


def init_mlstm_block(cfg: ModelConfig, *, generator: torch.Generator,
                     dtype=torch.bfloat16, device="cuda") -> MLSTMBlock:
    return L.init_params(MLSTMBlock(cfg, dtype=dtype, device=device),
                         generator)


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def _mlstm_core_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """Chunkwise-parallel mLSTM: O(S·C) D-matrices instead of O(S²).

    Within each chunk the stabilized quadratic form runs as usual; across
    chunks the matrix memory (C, n, m) is carried recurrently (the same
    closed-form state the serving path uses).  Equal to the parallel form
    up to fp rounding.  When ``chunk`` does not divide S it is the
    parallel form, as in the reference."""
    b, h, s, dh = q.shape
    if s % chunk:
        return _mlstm_core(q, k, v, i_pre, f_pre)
    n_chunks = s // chunk

    def chunks(z):
        return z.float().reshape(b, h, n_chunks, chunk, *z.shape[3:])

    qf, kf, vf, i_c = chunks(q), chunks(k), chunks(v), chunks(i_pre)
    lf_c = chunks(F.logsigmoid(f_pre.float()))
    scale = 1.0 / math.sqrt(dh)
    causal = _causal_mask(chunk, q.device)
    c_st = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n_st = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m_in = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    outs = []
    for j in range(n_chunks):
        qc, kc, vc = qf[:, :, j], kf[:, :, j], vf[:, :, j]
        ic, lfc = i_c[:, :, j], lf_c[:, :, j]
        cum_f = torch.cumsum(lfc, dim=-1)  # inclusive F_t
        # intra-chunk pairwise weights
        dmat = cum_f[..., :, None] - cum_f[..., None, :] + ic[..., None, :]
        dmat = torch.where(causal, dmat, -math.inf)
        inter = cum_f + m_in[..., None]  # (B,H,C): weight of carried state
        m_t = torch.maximum(dmat.amax(dim=-1), inter)
        w_intra = torch.exp(dmat - m_t[..., None])  # (B,H,C,C)
        w_inter = torch.exp(inter - m_t)  # (B,H,C)
        qs = qc * scale
        sw = torch.matmul(qs, kc.transpose(-1, -2)) * w_intra
        num = torch.matmul(sw, vc)
        num = num + w_inter[..., None] * torch.matmul(qs, c_st)
        den = sw.sum(-1) + w_inter * torch.einsum("bhtd,bhd->bht", qs, n_st)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])
        # end-of-chunk state update
        f_total = cum_f[..., -1]  # (B,H)
        rel = f_total[..., None] - cum_f + ic  # (B,H,C)
        m_out = torch.maximum(f_total + m_in, rel.amax(dim=-1))
        w_st = torch.exp(rel - m_out[..., None])
        decay = torch.exp(f_total + m_in - m_out)
        c_st = decay[..., None, None] * c_st + torch.einsum(
            "bhs,bhsd,bhse->bhde", w_st, kc, vc)
        n_st = decay[..., None] * n_st + torch.einsum(
            "bhs,bhsd->bhd", w_st, kc)
        m_in = m_out
    return torch.stack(outs, dim=2).reshape(b, h, s, dh)


def _mlstm_core(q, k, v, i_pre, f_pre):
    """Stabilized parallel mLSTM; q/k/v (B, H, S, dh); gates (B, H, S).
    Holds about five (B, H, S, S) fp32 tensors at once."""
    s, dh = q.shape[2], q.shape[3]
    log_f = F.logsigmoid(f_pre.float())  # (B,H,S)
    cum_f = torch.cumsum(log_f, dim=-1)
    # D[t, s] = cumF_t - cumF_s + i_s  for s <= t
    dmat = (cum_f[..., :, None] - cum_f[..., None, :]
            + i_pre.float()[..., None, :])
    dmat = torch.where(_causal_mask(s, q.device), dmat, -math.inf)
    m = dmat.amax(dim=-1, keepdim=True)  # (B,H,S,1)
    w = torch.exp(dmat - m)
    del dmat
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(dh)
    sw = scores * w
    del scores, w
    norm = torch.maximum(sw.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return torch.matmul(sw / norm, v.float())


def _heads(z: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, S, Di) -> (B, H, S, Di/H)."""
    b, s, di = z.shape
    return z.reshape(b, s, nh, di // nh).transpose(1, 2)


def mlstm_block(
    p: MLSTMBlock,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    return_state: bool = False,
):
    p = ctx.whole(p)  # the tp ranks repeat the block
    b, s, _ = x.shape
    nh = cfg.num_heads
    h_in = L.rmsnorm(p.norm, x, cfg.norm_eps)
    x_m, z = L.dense(p.w_in, h_in).chunk(2, dim=-1)  # (B, S, Di) each
    di = x_m.shape[-1]
    x_c = L.silu(_causal_conv(x_m, p.conv_w, p.conv_b))
    q = _heads(L.dense(p.w_q, x_c), nh)
    k = _heads(L.dense(p.w_k, x_c), nh)
    v = _heads(L.dense(p.w_v, x_m), nh)
    i_f = L.dense(p.w_if, x_c).transpose(1, 2)  # (B, 2H, S)
    i_pre, f_pre = i_f[:, :nh], i_f[:, nh:]  # (B, H, S) each
    if ctx.mlstm_chunk is not None and s > ctx.mlstm_chunk:
        core = _mlstm_core_chunked(q, k, v, i_pre, f_pre, ctx.mlstm_chunk)
    else:
        core = _mlstm_core(q, k, v, i_pre, f_pre)  # (B,H,S,dh) fp32
    core = L.rmsnorm(p.head_norm, core.to(x.dtype), cfg.norm_eps)
    core = core.transpose(1, 2).reshape(b, s, di)
    out = L.dense(p.w_out, core * L.silu(z))
    out = ctx.wsc(out, ctx.dp, None, None)
    if return_state:
        # closed-form final state of the recurrence (no sequential scan):
        # m_S = max_s(i_s + F_S - F_s); C = sum_s e^{i_s+F_S-F_s-m_S} k v^T
        cum_f = torch.cumsum(F.logsigmoid(f_pre.float()), dim=-1)
        rel = cum_f[..., -1:] - cum_f + i_pre.float()  # (B,H,S)
        m_state = rel.amax(dim=-1)  # (B,H)
        w = torch.exp(rel - m_state[..., None])  # (B,H,S)
        kf, vf = k.float(), v.float()
        state = {
            "c": torch.einsum("bhs,bhsd,bhse->bhde", w, kf, vf),
            "n": torch.einsum("bhs,bhsd->bhd", w, kf),
            "m": m_state,
            "conv": _conv_history(x_m),
        }
        return out, state
    return out


def mlstm_init_state(p: MLSTMBlock, cfg: ModelConfig, batch: int) -> dict:
    di = p.w_q.w.shape[1]
    nh = cfg.num_heads
    dh = di // nh
    kw = dict(dtype=torch.float32, device=p.w_q.w.device)
    return {
        "c": torch.zeros((batch, nh, dh, dh), **kw),
        "n": torch.zeros((batch, nh, dh), **kw),
        "m": torch.full((batch, nh), -math.inf, **kw),
        "conv": torch.zeros((batch, _CONV_TAPS - 1, di), **kw),
    }


def mlstm_step(p: MLSTMBlock, x_t: torch.Tensor, state: dict,
               cfg: ModelConfig):
    b = x_t.shape[0]
    nh = cfg.num_heads
    h_in = L.rmsnorm(p.norm, x_t, cfg.norm_eps)
    x_m, z = L.dense(p.w_in, h_in).chunk(2, dim=-1)
    di = x_m.shape[-1]
    dh = di // nh
    hist = torch.cat([state["conv"], x_m[:, None, :].float()], dim=1)
    x_c = L.silu(_conv_step(hist, p.conv_w, p.conv_b)).to(x_m.dtype)
    q = L.dense(p.w_q, x_c).reshape(b, nh, dh).float()
    k = L.dense(p.w_k, x_c).reshape(b, nh, dh).float()
    v = L.dense(p.w_v, x_m).reshape(b, nh, dh).float()
    i_f = L.dense(p.w_if, x_c).float()
    i_pre, f_pre = i_f[:, :nh], i_f[:, nh:]  # (B, H)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    f_s = torch.exp(log_f + state["m"] - m_new)
    i_s = torch.exp(i_pre - m_new)
    c = f_s[..., None, None] * state["c"] + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    qn = q / math.sqrt(dh)
    num = torch.einsum("bhd,bhde->bhe", qn, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qn, n).abs(),
                        torch.exp(-m_new))
    core = num / den[..., None]
    core = L.rmsnorm(p.head_norm, core.to(x_t.dtype), cfg.norm_eps)
    out = L.dense(p.w_out, core.reshape(b, di) * L.silu(z))
    return out, {"c": c, "n": n, "m": m_new, "conv": hist[:, 1:, :]}


# ============================== sLSTM block =================================


def _slstm_ff(d: int) -> int:
    return max(128, -(-(4 * d // 3) // 128) * 128)


class SLSTMBlock(nn.Module):
    """``norm``, ``w_gates`` (D, 4D: the i, f, z, o gates from the
    input), ``r_gates`` (4, H, Dh, Dh: block-diagonal recurrent weights
    per head, per gate), ``head_norm`` (width Dh), and the post-FFN
    ``w_up``/``w_down`` (4/3 expansion rounded up to 128)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        d = cfg.d_model
        nh = cfg.num_heads
        dh = d // nh
        kw = dict(dtype=dtype, device=device)
        self.norm = L.RMSNorm(d, device=device)
        self.w_gates = L.Dense(d, 4 * d, **kw)
        self.r_gates = L._param((4, nh, dh, dh), dtype, device)
        self.head_norm = L.RMSNorm(dh, device=device)
        self.w_up = L.Dense(d, _slstm_ff(d), **kw)
        self.w_down = L.Dense(_slstm_ff(d), d, **kw)

    def reset_parameters(self, generator=None) -> None:
        """``r_gates`` N(0, 1/D) drawn in fp32 and cast."""
        d = self.w_gates.w.shape[0]
        x = torch.randn(self.r_gates.shape, generator=generator,
                        device=self.r_gates.device, dtype=torch.float32)
        self.r_gates.data.copy_(x * (1.0 / math.sqrt(d)))


def init_slstm_block(cfg: ModelConfig, *, generator: torch.Generator,
                     dtype=torch.bfloat16, device="cuda") -> SLSTMBlock:
    return L.init_params(SLSTMBlock(cfg, dtype=dtype, device=device),
                         generator)


def slstm_init_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    kw = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), **kw),
        "n": torch.ones((batch, d), **kw),
        "m": torch.zeros((batch, d), **kw),
        "h": torch.zeros((batch, d), **kw),
    }


def _slstm_cell(r_gates: torch.Tensor, gx: torch.Tensor, state: dict) -> dict:
    """One sLSTM time step.  ``r_gates`` (4, H, Dh, Dh) fp32; ``gx``
    (4, B, D) fp32, the input part of the i, f, z, o gates."""
    nh, dh = r_gates.shape[1], r_gates.shape[2]
    b, d = gx.shape[1], gx.shape[2]
    h_prev = state["h"].reshape(b, nh, dh).transpose(0, 1)  # (H, B, Dh)
    rec = torch.matmul(h_prev[None], r_gates)  # (4, H, B, Dh)
    pre = gx + rec.transpose(1, 2).reshape(4, b, d)
    i_pre, f_pre, z_pre, o_pre = pre.unbind(0)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(z_pre)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}


def _gate_inputs(gates_x: torch.Tensor) -> torch.Tensor:
    """(..., 4D) input gates -> (..., 4, D) fp32 -> gate axis first."""
    g = gates_x.float()
    g = g.reshape(*g.shape[:-1], 4, g.shape[-1] // 4)
    return g.movedim(-2, 0)


def _slstm_out(p: SLSTMBlock, hs: torch.Tensor, cfg: ModelConfig,
               dtype) -> torch.Tensor:
    """Head norm of the fp32 hidden states (..., D) in ``dtype``, then the
    post-FFN (gelu in ``dtype``)."""
    d = hs.shape[-1]
    nh = cfg.num_heads
    hs = L.rmsnorm(p.head_norm, hs.reshape(*hs.shape[:-1], nh, d // nh)
                   .to(dtype), cfg.norm_eps).reshape(hs.shape)
    return L.dense(p.w_down, L.gelu(L.dense(p.w_up, hs)))


def slstm_block(
    p: SLSTMBlock,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    *,
    return_state: bool = False,
):
    p = ctx.whole(p)  # the tp ranks repeat the block
    b, s, _ = x.shape
    h_in = L.rmsnorm(p.norm, x, cfg.norm_eps)
    gates_x = L.dense(p.w_gates, h_in)  # (B, S, 4D)
    if ctx.slstm_replicated:
        # keep the whole recurrence tp-replicated: one all-gather here
        # instead of per-timestep collectives inside the loop
        gates_x = ctx.wsc(gates_x, ctx.dp, None, None)
    gx = _gate_inputs(gates_x)  # (4, B, S, D)
    del gates_x
    r_gates = p.r_gates.float()  # cast once, not per step
    state = slstm_init_state(cfg, b, device=x.device)
    hs = []
    steps = cost.loop_steps(s)  # s, unless a dry run samples the loop
    for t in range(steps):
        state = _slstm_cell(r_gates, gx[:, :, t], state)
        hs.append(state["h"])
    hs += hs[-1:] * (s - steps)
    out = _slstm_out(p, torch.stack(hs, dim=1), cfg, x.dtype)  # (B, S, D)
    out = ctx.wsc(out, ctx.dp, None, None)
    if return_state:
        return out, state
    return out


def slstm_step(p: SLSTMBlock, x_t: torch.Tensor, state: dict,
               cfg: ModelConfig):
    h_in = L.rmsnorm(p.norm, x_t, cfg.norm_eps)
    new = _slstm_cell(p.r_gates.float(),
                      _gate_inputs(L.dense(p.w_gates, h_in)), state)
    return _slstm_out(p, new["h"], cfg, x_t.dtype), new
