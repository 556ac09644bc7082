"""Primitive layers: norms, dense projections, embeddings, RoPE.

The port of ``repro.models.layers``.  Parameters live in small
``nn.Module``s whose parameter names are the reference's dictionary keys
(``Dense.w``/``.b``, ``RMSNorm.scale``, ``Embedding.embedding``), so a
parameter path of the port equals the reference's pytree path.  Each
module allocates its parameters on construction and draws them in
``reset_parameters(generator)`` from the reference's distributions;
functions (``rmsnorm``, ``dense``, ...) apply them, as in the
reference.  Parameters are created frozen (``requires_grad=False``), so
the inference paths record no graph; the train state
(``train.train_step.make_train_state``) turns them on with
``requires_grad_()``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ACTIVATIONS", "Dense", "Embedding", "LayerNorm", "MROPE_SECTIONS",
    "RMSNorm", "apply_mrope", "apply_rope", "dense", "embed", "gelu", "init_params", "layernorm",
    "fill_after_node", "matmul_f32", "rmsnorm", "rope_frequencies", "silu", "torch_dtype",
    "unembed",
]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module``'s layers from ``generator``, in
    module order: each submodule with a ``reset_parameters(generator)``
    (the layers here, ``models.moe.MoE``) draws its own; returns
    ``module``."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """``a @ b`` (2-D) as exact products summed in fp32, returned in fp32
    (written into ``out``, an fp32 tensor, when given).

    On the card a pair of one narrower dtype goes to one GEMM with an fp32
    output (``torch.mm(..., out_dtype=torch.float32)``).  A pair of mixed
    dtypes (an fp32 cotangent beside a bf16 weight) is widened to fp32
    first, so no operand is rounded; so is every pair on the CPU, which
    has no such kernel.  A ``meta`` pair takes the card's route, so a
    shape-only count (``analysis.cost``) counts the card's ops.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.mm(a, b, out=out)
    if a.device.type == "cpu" or a.dtype != b.dtype:
        return torch.mm(a.float(), b.float(), out=out)
    return torch.mm(a, b, out_dtype=torch.float32, out=out)


def fill_after_node(y: torch.Tensor, compute) -> torch.Tensor:
    """Write ``compute()`` into ``y``, the unfilled result of an autograd
    node that has already saved its operands, outside autograd; returns
    ``y``.  ``compute`` may take ``y`` to write an fp32 result in place.

    Why the split: a custom ``autograd.Function`` saves its operands only
    after its forward returns, where an aten op saves them before it
    computes.  ``torch.utils.checkpoint``'s recompute stops once the last
    saved operand is back, so a product computed inside its node's
    forward is recomputed even when it is a unit's last product, whose
    result nothing in the backward reads; computed after the node, it is
    not, which is what XLA's remat leaves after removing dead code."""
    with torch.no_grad():
        out = compute(y if y.dtype == torch.float32 else None)
        if out is not y:
            y.copy_(out)
    return y


def _records(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _MatmulF32(torch.autograd.Function):
    """The node of ``_mm_f32`` cast to ``out_dtype``, with a derivative
    (``torch.mm(..., out_dtype=...)`` has none): the gradient of each
    operand is again a product summed in fp32 of the cotangent, in the
    output's dtype, and the other operand, returned in that operand's
    dtype, as the reference's transpose of a
    ``preferred_element_type=float32`` product is.  Its forward only saves
    the operands and allocates the result; ``matmul_f32`` fills it
    (``fill_after_node``)."""

    @staticmethod
    def forward(ctx, x2, w, out_dtype):
        ctx.save_for_backward(x2, w)
        return x2.new_empty((x2.shape[0], w.shape[1]), dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x2.t(), g).to(w.dtype)
        return dx, dw, None


def matmul_f32(x: torch.Tensor, w: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` (x (..., K), w (K, N)) as exact products summed in fp32,
    returned in ``out_dtype``: the reference's
    ``preferred_element_type=float32``, then ``.astype(out_dtype)``.

    On the card a bf16 pair goes to one bf16 GEMM with an fp32 output
    (``torch.mm(..., out_dtype=torch.float32)``); on the CPU, which has
    no such kernel, the operands are widened first.  Differentiable: the
    backward runs two more such products (``_MatmulF32``), with the
    cotangent in ``out_dtype``: a bf16 one keeps the bf16 GEMM, an fp32
    one (the tied head's logits) widens the other operand.
    """
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w).to(out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _records(x2, w):
        y = fill_after_node(_MatmulF32.apply(x2, w, out_dtype),
                            lambda out: _mm_f32(x2, w, out))
    else:
        y = _mm_f32(x2, w).to(out_dtype)
    return y.reshape(*lead, w.shape[-1])


# -- norms -------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device="cuda"):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)

    def reset_parameters(self, generator=None) -> None:
        del generator
        self.scale.data.fill_(1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + p.scale.float())).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, device="cuda"):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)
        self.bias = _param((d,), torch.float32, device)

    def reset_parameters(self, generator=None) -> None:
        del generator
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p.scale + p.bias).to(x.dtype)


# -- dense -------------------------------------------------------------------


class Dense(nn.Module):
    """``w`` (in_dim, out_dim) drawn N(0, 1/in_dim) in fp32 and cast to
    ``dtype``; an optional bias ``b`` of zeros."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.w = _param((in_dim, out_dim), dtype, device)
        self.b = _param((out_dim,), dtype, device) if bias else None

    def reset_parameters(self, generator=None) -> None:
        in_dim = self.w.shape[0]
        w = torch.randn(self.w.shape, generator=generator,
                        device=self.w.device, dtype=torch.float32)
        self.w.data.copy_(w * (1.0 / math.sqrt(in_dim)))
        if self.b is not None:
            self.b.data.zero_()


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p.w)
    if p.b is not None:
        y = y + p.b
    return y


# -- embeddings --------------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.embedding = _param((vocab, d), dtype, device)

    def reset_parameters(self, generator=None) -> None:
        e = torch.randn(self.embedding.shape, generator=generator,
                        device=self.embedding.device, dtype=torch.float32)
        self.embedding.data.copy_(e)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p.embedding)


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in fp32 for a stable softmax/CE."""
    return matmul_f32(x, p.embedding.t())


# -- rotary embeddings -------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(
    x: torch.Tensor,  # (B, S, H, Dh)
    positions: torch.Tensor,  # (B, S)
    theta: float = 10_000.0,
) -> torch.Tensor:
    """Rotate the two halves of each head (not interleaved pairs)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)  # (Dh/2,)
    angles = positions[..., None].float() * freqs  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# M-RoPE (Qwen2-VL): the rotary frequency bands are partitioned into three
# sections (temporal, height, width); each section rotates by its own
# position stream.  Text tokens carry identical positions in all three
# streams, so M-RoPE degenerates to RoPE for text.
MROPE_SECTIONS = (0.25, 0.375, 0.375)  # fractions of Dh/2 per (t, h, w)


def apply_mrope(
    x: torch.Tensor,  # (B, S, H, Dh)
    positions: torch.Tensor,  # (B, S, 3) -> (t, h, w) position per token
    theta: float = 1_000_000.0,
) -> torch.Tensor:
    dh = x.shape[-1]
    half = dh // 2
    freqs = rope_frequencies(dh, theta, x.device)  # (half,)
    n_t = int(half * MROPE_SECTIONS[0])
    n_h = int(half * MROPE_SECTIONS[1])
    section = torch.full((half,), 2, dtype=torch.int64, device=x.device)
    section[:n_t] = 0
    section[n_t:n_t + n_h] = 1
    pos = positions.float()[..., section]  # (B, S, half): per-band stream
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- misc --------------------------------------------------------------------


# The activations are written op by op in the input's dtype, as jax.nn
# defines them: in bf16 every step rounds where the reference's does,
# where F.silu / F.gelu would round once at the end.


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def _const(value: float, x: torch.Tensor) -> float:
    """``value`` rounded to ``x``'s dtype, as the reference's weakly typed
    constant is, kept a Python scalar: a scalar operand needs no copy to
    the device, and a copy from host memory would make the stream wait."""
    return _rounded(value, x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x)
    )
    return x * (0.5 * (1.0 + torch.tanh(inner)))


ACTIVATIONS = {
    "swiglu": silu,
    "geglu": gelu,
    "gelu": gelu,
}
