"""Flash attention (forward): the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_fa_kernel``
(driven by ``flash_attention_pallas``): softmax attention of ``q``
(B, H, Sq, Dh) over ``k``, ``v`` (B, Hkv, Sk, Dh) with GQA head groups
(query head ``h`` reads kv head ``h // (H / Hkv)`` of its batch), a causal
mask (key <= query) and a sliding window (query - key < window), scale
``1/sqrt(Dh)`` unless given, computed in fp32 and returned in ``q``'s
dtype.  A query row with no live key gives 0, as the TPU kernel gives
for a row whose every key tile it skips; the reference's
``ref.flash_attention_ref`` gives NaN there (a softmax of all ``-inf``).

The kernel (``csrc/flash_attention.cu``) has two routes, chosen by the
dtype.  bf16 runs on the tensor cores: a block of three warpgroups owns
128 query rows of one (batch, head); a producer thread streams K/V tiles
through TMA into a ring of shared-memory stages, and two consumer
warpgroups of 64 rows compute S = Q·Kᵀ and O += P·V with ``wgmma``, P
kept in registers (as two bf16 parts, hi and lo, so P·V keeps P to
~2⁻¹⁷ where one bf16 P would lose the bf16 hold on short rows).  fp32
runs the fp32-FMA kernel (never TF32, for the reference's fp32
tolerance).  Both loop over only the key tiles the masks leave live,
take any Dh from 1 to 256 (``HEAD_DIMS``), any Sq and Sk (the ragged
tail is masked) and (batch, head, sequence) strides with Dh contiguous,
so the attention layer's transposed views need no copy; the output has
``q``'s layout.  The kernel is instantiated for the widths
``KERNEL_HEAD_DIMS``; a head width runs on the next of them at or above
it, its columns past Dh read as zero (TMA's fill on the bf16 route, a
masked load on the fp32 one) and never stored, so nothing is padded or
copied on the host.
TMA reads the bf16 operands, so their pointers must be 16-byte aligned
and their strides in bytes multiples of 16 (``tma_operand_problems``).
At the LM's shape (B = 4, H = 32, Hkv = 8, S = 4096, Dh = 64, bf16,
causal) the live work is 2.7e11 FLOP against 0.17 GB of operands:
bound by operations, 0.28 ms at the card's 989 TFLOP/s of bf16 tensor
cores.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["check_kernel_operands", "flash_attention_cuda",
           "flash_attention_plain", "tma_operand_problems"]

#: head widths the CUDA kernel takes
HEAD_DIMS = range(1, 257)
#: widths it is instantiated for (csrc/flash_attention.cu): a head width
#: runs on the next of them at or above it
KERNEL_HEAD_DIMS = (64, 128, 256)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, H, Sq, Dh) and k, v (B, Hkv, Sk, Dh) of one shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"batch or head width differ: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}"
        )
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} must be a multiple of kv heads "
            f"{k.shape[1]}"
        )


def _live_mask(sq: int, sk: int, causal: bool, window: int | None,
               device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query may attend to."""
    pos_q = torch.arange(sq, device=device)[:, None]
    pos_k = torch.arange(sk, device=device)[None, :]
    live = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        live &= pos_q >= pos_k
    if window is not None:
        live &= pos_q - pos_k < window
    return live


def check_kernel_operands(q, k, v) -> None:
    """The kernel's checks of its operands but their device and TMA's
    alignment (the shape-only route of ``kernels.ops`` runs them too)."""
    _check_shapes(q, k, v)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(
            f"the flash-attention kernel takes head widths from 1 to "
            f"{HEAD_DIMS[-1]}, not {q.shape[3]}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"operand dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(
                f"{name} must have unit stride along Dh (got strides "
                f"{x.stride()})"
            )


def tma_operand_problems(name: str, x: torch.Tensor) -> list[str]:
    """Why TMA cannot read ``x`` (B, H, S, Dh) as the bf16 kernel does:
    each condition it breaks, named; empty if it can.

    A tensor map needs a 16-byte aligned address and sequence, head and
    batch strides whose byte counts are multiples of 16 (a dimension of
    extent 1 is never stepped, so its stride does not matter).  Runs on
    tensors of any device, so the check can be tested without a card.
    """
    problems = []
    if x.data_ptr() % 16:
        problems.append(f"{name}.data_ptr() is not 16-byte aligned "
                        f"(address % 16 = {x.data_ptr() % 16})")
    for dim, what in ((2, "sequence"), (1, "head"), (0, "batch")):
        nbytes = x.stride(dim) * x.element_size()
        if x.shape[dim] > 1 and nbytes % 16:
            problems.append(f"{name}'s {what} stride of {nbytes} bytes is "
                            f"not a multiple of 16")
    return problems


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Attention by materialising the (B, H, Sq, Sk) fp32 scores.

    The reference's ``flash_attention_ref`` math (fp32 scores of the
    scaled queries, masked, softmax, times V) written as ``exp(s - max)``
    normalised after the product with V, so that a row with no live key
    gives 0 and not NaN.  Outside autograd the scores are updated in
    place: one fp32 buffer of B·H·Sq·Sk elements is the peak (8.6 GB at
    B = 4, H = 32, S = 4096), freed on return.  While autograd records
    (an operand requires grad) the same ops run out of place, and the row
    maximum is a constant of the graph (the softmax does not depend on
    it), so the gradient is the reference's.
    """
    _check_shapes(q, k, v)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    qg = (q.float() * scale).reshape(b, hkv, g, sq, dh)
    s = torch.matmul(qg, k.float().unsqueeze(2).transpose(-1, -2))
    del qg
    dead = ~_live_mask(sq, sk, causal, window, q.device)
    if records:
        s = s.masked_fill(dead, float("-inf"))
    else:
        s.masked_fill_(dead, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    # exp(-inf) = 0 on masked keys
    p = (s - m).exp() if records else s.sub_(m).exp_()
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float().unsqueeze(2))
    del s, p
    out = out / torch.where(denom == 0, torch.ones_like(denom), denom)
    return out.reshape(b, h, sq, dh).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Attention through the CUDA kernel; counts its launches.

    ``q``, ``k``, ``v`` are float32 or bfloat16 CUDA tensors of one dtype,
    any Dh from 1 to 256 (``HEAD_DIMS``; wider raises), each with unit
    last stride (any batch, head and sequence strides; in bf16 a 16-byte
    aligned pointer and strides of a multiple of 16 bytes, else
    ``ValueError`` naming the condition).  The
    result is a new tensor of ``q``'s shape, dtype and layout
    (``torch.empty_like``).
    """
    check_kernel_operands(q, k, v)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention_cuda needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    code = _build.dtype_code(q.dtype)
    if q.dtype == torch.bfloat16:  # the tensor-core route reads via TMA
        problems = [p for name, x in (("q", q), ("k", k), ("v", v))
                    for p in tma_operand_problems(name, x)]
        if problems:
            raise ValueError(
                "the bf16 flash-attention kernel reads its operands through "
                "TMA: " + "; ".join(problems)
            )
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    o = torch.empty_like(q)
    err = _build.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
        sq, sk, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], float(scale), int(causal), int(window is not None),
        0 if window is None else int(window), code,
        _build.stream_handle(q.device),
    )
    _build.check(err, "flash_attention kernel launch")
    flash_attention_cuda.launches += 1
    return o


#: kernel launches so far (a plain integer; set it to 0 to start a count)
flash_attention_cuda.launches = 0
