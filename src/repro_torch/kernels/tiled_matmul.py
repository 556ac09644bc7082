"""Dense tiled matmul: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/tiled_matmul.py::
tiled_matmul_kernel`` (driven by ``tiled_matmul_pallas``), the local
block-multiply engine of task-based SUMMA: every panel product of
``core.summa._local_dot`` on the ``local_matmul="pallas"`` route.

The kernel (``csrc/tiled_matmul.cu`` on ``csrc/block_rows.cuh`` and the
engine of ``csrc/split_gemm.cuh``) runs the products on the bf16 tensor
cores (``wgmma``): an fp32 operand is split into hi = bf16(x) and lo =
bf16(x - hi) and three products, hi·hi + hi·lo + lo·hi, are accumulated
in fp32, which holds the reference's fp32 tolerance; bf16 operands take
one product.  One persistent block a multiprocessor walks work items of
two 64-row units of A by one 256-column tile of C, computed on the card
from the item's index; a producer warpgroup streams B's k-slabs, split,
into shared memory, and each of two consumer warpgroups builds its unit's
A fragments in registers.  It takes A and B with a row stride, so
SUMMA's K-panel views of a shard need no copy, and masks every edge of
M, N and K; an fp32 C takes a K past 2048 in parts, as the tensor
cores' accumulation loses precision over a long sum.  At the main path's panel shape, (32768 x 256) . (256 x
32768) in fp32, the function's 5.5e11 FLOP take 0.56 ms at the bf16
peak against 4.4 GB moved, 1.3 ms at 3.35 TB/s: bound by bytes, by
writing C.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["check_kernel_operands", "tiled_matmul_cuda", "tiled_matmul_plain"]


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b`` in fp32, cast to ``out_dtype`` (default ``a.dtype``)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def _check_row_major(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(x.shape)}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError(
            f"{name} must have unit column stride (got strides {x.stride()})"
        )


def check_kernel_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    """The kernel's checks of its operands but their device (the
    shape-only route of ``kernels.ops`` runs them too)."""
    _check_row_major(a, "a")
    _check_row_major(b, "b")
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")


def tiled_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b`` through the CUDA kernel; counts its launches.

    ``a`` (M, K) and ``b`` (K, N) are float32 or bfloat16 CUDA tensors of
    one dtype, each row-major with any row stride; the result is a new
    contiguous (M, N) tensor of ``out_dtype`` (default ``a.dtype``).
    """
    out_dtype = out_dtype or a.dtype
    check_kernel_operands(a, b)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(
            f"tiled_matmul_cuda needs both operands on one CUDA device, got "
            f"{a.device} and {b.device}"
        )
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.load().tiled_matmul_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        a.stride(0), b.stride(0), _build.dtype_code(a.dtype),
        _build.dtype_code(out_dtype), _build.stream_handle(a.device),
    )
    _build.check(err, "tiled_matmul kernel launch")
    tiled_matmul_cuda.launches += 1
    return c


#: kernel launches so far (a plain integer; set it to 0 to start a count)
tiled_matmul_cuda.launches = 0
