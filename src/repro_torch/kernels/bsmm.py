"""Block-sparse matmul (BSMM): the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/bsmm.py::bsmm_kernel`` (driven by
``bsmm_pallas``), the compute payload of the paper's block-sparse tensor
computing: C = A . B where A's live (bm x bk) blocks are listed by a padded
CSR column map ``cols`` of shape (M/bm, S), int32, each row padded with
-1 after its live entries (``BlockCSR.padded_cols``, the planner's
``plan.local_cols``).  Where B is block-sparse too, the map may hold one
list a block row and 256-column tile of C (``TILE_COLS``, the kernel's
tile): (M/bm, ceil(N/256), S), A's live blocks whose (bk x 256) block of B
is live (``core.summa._plan_constants`` builds it).  The blocks of B a list
leaves out are never read: the function multiplies the listed blocks only.

The kernel (``csrc/bsmm.cu``) is the dense kernel's split-bf16 ``wgmma``
design (``kernels/tiled_matmul.py``, ``csrc/block_rows.cuh``), where a
work item is two 64-row units of one block row by one 256-column tile of
C (a block row of fewer than 64 rows is one unit, and the second consumer
idles).  Each block reads its item's list of ``cols`` itself — in place
of the TPU's scalar prefetch — and walks it until the first entry that is
not a block column of A (-1, or one at or past K/bk, which is never
read), summing every listed block's k-slabs in fp32 (an fp32 C takes the
sum in parts of K = 2048: the tensor cores' accumulation loses precision
over a long sum); an item with an empty list writes zeros.  Its FLOPs
follow the listed blocks (2 bm bk 256 each a tile): at the main path's
shapes (bm = bk = 256, N = 32768, A and B at fill 0.3) A's map alone
lists 2.1e13 FLOP, 21.4 ms at the bf16 peak, the lists a tile the useful
6.32e12, 6.4 ms, bound by operations (the split's three products: 64 and
19.2 ms).  Nothing balances longer lists against shorter ones beyond the
persistent walk over many items.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain

__all__ = ["TILE_COLS", "bsmm_cuda", "bsmm_plain", "check_kernel_operands",
           "tile_lists"]

#: columns of C a list of a tile map covers (``split_gemm::kCols``)
TILE_COLS = 256


def tile_lists(cols: np.ndarray, live: np.ndarray) -> np.ndarray:
    """A tile map from a map of one list a block row: ``cols`` (M/bm, S),
    each list read up to its first -1, and ``live`` (K/bk, T) bool, whether
    B's (bk x 256) block under tile t of block column kk is live.  Each
    block row's list for tile t keeps its entries whose block of B is
    live, in order, padded with -1: (M/bm, T, S'), S' the longest list."""
    cols = np.asarray(cols, np.int32)
    valid = np.logical_and.accumulate(cols >= 0, axis=-1)
    # (M/bm, T, S): which entries of each list a tile keeps
    keep = valid[:, None, :] & live[np.where(valid, cols, 0)].transpose(0, 2, 1)
    order = np.argsort(~keep, axis=-1, kind="stable")
    kept = keep.sum(axis=-1)
    s = int(kept.max())
    picked = np.take_along_axis(
        np.broadcast_to(cols[:, None, :], keep.shape), order[..., :s], -1)
    return np.ascontiguousarray(
        np.where(np.arange(s) < kept[..., None], picked, -1), np.int32)


def _check_shapes(a, b, cols, bm, bk, bn) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    m, k = a.shape
    n = b.shape[1]
    if m % bm or k % bk or n % bn:
        raise ValueError(f"shape must divide tiles ({bm},{bk},{bn})")
    if cols.dim() not in (2, 3) or cols.shape[0] != m // bm:
        raise ValueError(
            f"col map {tuple(cols.shape)} must have M/bm={m // bm} rows"
        )
    if cols.dim() == 3 and cols.shape[1] != -(-n // TILE_COLS):
        raise ValueError(
            f"tile map {tuple(cols.shape)} must have a list for each of the "
            f"{-(-n // TILE_COLS)} {TILE_COLS}-column tiles of N={n}"
        )


def _live_prefix(cols: torch.Tensor, k_blocks: int) -> torch.Tensor:
    """Which entries of ``cols`` the kernel reads: those before the first
    entry of their list outside [0, k_blocks)."""
    ok = (cols >= 0) & (cols < k_blocks)
    return ok.to(torch.int32).cumprod(dim=-1).bool()


def _listed(cols: torch.Tensor, k_blocks: int) -> torch.Tensor:
    """The (M/bm, K/bk) mask of the blocks an (M/bm, S) map lists."""
    live = _live_prefix(cols, k_blocks)
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    mask = torch.zeros((cols.shape[0], k_blocks), dtype=torch.bool,
                       device=cols.device)
    mask[rows.expand_as(cols)[live], cols[live]] = True
    return mask


def _keep(x: torch.Tensor, mask: torch.Tensor, bm: int, bk: int):
    """``x`` with the (bm x bk) blocks ``mask`` leaves out set to zero."""
    keep = mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def bsmm_plain(a: torch.Tensor, b: torch.Tensor, cols: torch.Tensor, *,
               bm: int, bk: int, bn: int,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Zero the blocks of ``a`` absent from ``cols``, then ``a @ b`` in fp32
    cast to ``out_dtype`` (default ``a.dtype``).  A tile map's lists go
    tile by tile: each ``TILE_COLS`` columns of C are the listed blocks of
    ``a`` times ``b``'s columns of the tile, in which the blocks that no
    list of the tile names are zeroed too (they are never read)."""
    _check_shapes(a, b, cols, bm, bk, bn)
    m, k = a.shape
    cols = cols.to(a.device, torch.int64)
    if cols.dim() == 2:
        return tiled_matmul_plain(_keep(a, _listed(cols, k // bk), bm, bk),
                                  b, out_dtype)
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype or a.dtype, device=a.device)
    for t in range(cols.shape[1]):
        tile = slice(t * TILE_COLS, min(n, (t + 1) * TILE_COLS))
        mask = _listed(cols[:, t], k // bk)
        b_t = _keep(b[:, tile], mask.any(0)[:, None], bk, c[:, tile].shape[1])
        c[:, tile] = tiled_matmul_plain(_keep(a, mask, bm, bk), b_t,
                                        out_dtype)
    return c


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
    tensors of one dtype; ``cols`` is a contiguous int32 map on the same
    device, (M/bm, S) or a tile map (M/bm, ceil(N/256), S).  Each list's
    walk ends at its first entry outside [0, K/bk), in the kernel, so a
    launch never waits on the card to check the map
    (``kernels.ops.bsmm_cols`` refuses such a map on the host).
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
        a.stride(0), b.stride(0), cols.shape[-1], a.shape[1] // bk, bm, bk,
        int(cols.dim() == 3), _build.dtype_code(a.dtype),
        _build.dtype_code(out_dtype),
        _build.stream_handle(a.device),
    )
    _build.check(err, "bsmm kernel launch")
    bsmm_cuda.launches += 1
    return c


#: kernel launches so far (a plain integer; set it to 0 to start a count)
bsmm_cuda.launches = 0
