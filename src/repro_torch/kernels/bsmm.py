"""Block-sparse matmul (BSMM): the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/bsmm.py::bsmm_kernel`` (driven by
``bsmm_pallas``), the compute payload of the paper's block-sparse tensor
computing: C = A . B where A's live (bm x bk) blocks are listed by a padded
CSR column map ``cols`` of shape (M/bm, S), int32, each row padded with
-1 after its live entries (``BlockCSR.padded_cols``, the planner's
``plan.local_cols``).

The kernel (``csrc/bsmm.cu``) is the dense kernel's split-bf16 ``wgmma``
design (``kernels/tiled_matmul.py``, ``csrc/block_rows.cuh``), where a
work item is two 64-row units of one block row by one 256-column tile of
C (a block row of fewer than 64 rows is one unit, and the second consumer
idles).  Each block reads its block row's entries of ``cols`` itself —
in place of the TPU's scalar prefetch — and walks them until the first
entry that is not a block column of A (-1, or one at or past K/bk, which
is never read), summing every live block's k-slabs in fp32 (an fp32 C
takes the sum in parts of K = 2048: the tensor cores' accumulation
loses precision over a long sum); a block row with no live block writes
zeros.  Its FLOPs
follow the live blocks (2 bm bk N each): at the main path's shapes
(bm = bk = 256, N = 32768, fill 0.3) it is bound by operations, 21.4 ms
of them at the bf16 peak (the split's three products: 64 ms).
Nothing balances block rows with more live blocks against those with
fewer beyond the persistent walk over many items.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain

__all__ = ["bsmm_cuda", "bsmm_plain", "check_kernel_operands"]


def _check_shapes(a, b, cols, bm, bk, bn) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    m, k = a.shape
    n = b.shape[1]
    if m % bm or k % bk or n % bn:
        raise ValueError(f"shape must divide tiles ({bm},{bk},{bn})")
    if cols.dim() != 2 or cols.shape[0] != m // bm:
        raise ValueError(
            f"col map {tuple(cols.shape)} must have M/bm={m // bm} rows"
        )


def _live_prefix(cols: torch.Tensor, k_blocks: int) -> torch.Tensor:
    """Which entries of ``cols`` the kernel reads: those before the first
    entry of their row outside [0, k_blocks)."""
    ok = (cols >= 0) & (cols < k_blocks)
    return ok.to(torch.int32).cumprod(dim=1).bool()


def bsmm_plain(a: torch.Tensor, b: torch.Tensor, cols: torch.Tensor, *,
               bm: int, bk: int, bn: int,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Zero the blocks of ``a`` absent from ``cols``, then ``a @ b`` in fp32
    cast to ``out_dtype`` (default ``a.dtype``)."""
    _check_shapes(a, b, cols, bm, bk, bn)
    m, k = a.shape
    cols = cols.to(a.device, torch.int64)
    live = _live_prefix(cols, k // bk)
    rows = torch.arange(m // bm, device=a.device)[:, None].expand_as(cols)
    mask = torch.zeros((m // bm, k // bk), dtype=torch.bool, device=a.device)
    mask[rows[live], cols[live]] = True
    keep = mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    a_z = torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))
    return tiled_matmul_plain(a_z, b, out_dtype)


def check_kernel_operands(a, b, cols, bm: int, bk: int, bn: int) -> None:
    """The kernel's checks of its operands but their device (the
    shape-only route of ``kernels.ops`` runs them too)."""
    _check_shapes(a, b, cols, bm, bk, bn)
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and cols.is_contiguous()):
        raise ValueError("bsmm_cuda needs contiguous a, b and cols")


def bsmm_cuda(a: torch.Tensor, b: torch.Tensor, cols: torch.Tensor, *,
              bm: int, bk: int, bn: int,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Block-sparse ``a @ b`` through the CUDA kernel; counts its launches.

    ``a`` (M, K) and ``b`` (K, N) are contiguous float32 or bfloat16 CUDA
    tensors of one dtype; ``cols`` is a contiguous int32 (M/bm, S) map on
    the same device.  Each row's walk ends at its first entry outside
    [0, K/bk), in the kernel, so a launch never waits on the card to check
    the map (``kernels.ops.bsmm_cols`` refuses such a map on the host).
    ``bn`` only has to divide N (the reference's tile contract); the
    kernel tiles N by 256 and masks the edge.
    """
    out_dtype = out_dtype or a.dtype
    check_kernel_operands(a, b, cols, bm, bk, bn)
    if not (a.is_cuda and b.device == a.device and cols.device == a.device):
        raise ValueError(
            "bsmm_cuda needs a, b and cols on one CUDA device, got "
            f"{a.device}, {b.device} and {cols.device}"
        )
    m = a.shape[0]
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.load().bsmm_launch(
        a.data_ptr(), b.data_ptr(), cols.data_ptr(), c.data_ptr(), m, n,
        a.stride(0), b.stride(0), cols.shape[1], a.shape[1] // bk, bm, bk,
        _build.dtype_code(a.dtype), _build.dtype_code(out_dtype),
        _build.stream_handle(a.device),
    )
    _build.check(err, "bsmm kernel launch")
    bsmm_cuda.launches += 1
    return c


#: kernel launches so far (a plain integer; set it to 0 to start a count)
bsmm_cuda.launches = 0
