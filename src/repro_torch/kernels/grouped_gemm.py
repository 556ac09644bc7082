"""Grouped GEMM: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/grouped_gemm.py::
grouped_gemm_kernel`` (driven by ``grouped_gemm_pallas``): tokens ``x``
(T, D) arrive sorted into ``bt``-row tiles, each owned by one expert, and
``y[tile] = x[tile] . w[tile_expert[tile]]`` for expert weights ``w``
(E, D, F), accumulated in fp32 and cast to ``out_dtype``.  On the
rank-sparse route the tokens are rows of the V factors, a tile is one
block's ``r_pad`` rows, and the experts are the K-panels of B
(``core.summa._exec_ranksparse_grouped``, ``kernels.ops.ranksparse_matmul``).

The kernel (``csrc/grouped_gemm.cu`` on the engine of
``csrc/split_gemm.cuh``) runs the products on the bf16 tensor cores
(``wgmma``): an fp32 operand is split into hi = bf16(x) and lo =
bf16(x - hi) and three products, hi·hi + hi·lo + lo·hi, are accumulated
in fp32, which holds the reference's fp32 tolerance; bf16 operands take
one product.  A block of 384 threads owns one 256-column tile of y and
two 64-row *units* of one expert (a unit is a 64-row sub-tile of a token
tile; a tile shorter than 64 rows, ``bt`` = 8, 16, 24, is one unit), one
per consumer warpgroup, while a producer warpgroup streams the expert's
W slice, split, into shared memory; so no block mixes experts and each
slice of W read feeds 128 token rows.  The wrapper builds the pairs on
the host from the tile map, which the caller gives on the host
(``tile_pairs``), and copies both to the card as int32 lists without
waiting for it.  ``w`` is read through its expert and row
strides, so the K-panels of one row-major B serve as experts without a
copy.  On the main path (``bt`` = 64, D = 256, F = 32768, 128 experts,
fp32) the work is 4 (T D + E D F + T F) = 12.9 GB against three bf16
products of 2 T D F FLOP each: bound by bytes, 3.85 ms at the card's
3.35 TB/s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["check_kernel_operands", "grouped_gemm_cuda", "grouped_gemm_plain",
           "host_to_device", "tile_pairs"]

#: rows of a unit: one consumer warpgroup's wgmma rows (csrc/split_gemm.cuh)
UNIT_ROWS = 64


def _check_shapes(x, w, tile_expert, bt) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(
            f"contraction mismatch: {tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if bt <= 0 or x.shape[0] % bt:
        raise ValueError(f"token count {x.shape[0]} must divide tile {bt}")
    if tuple(tile_expert.shape) != (x.shape[0] // bt,):
        raise ValueError(
            f"tile_expert {tuple(tile_expert.shape)} must have one entry per "
            f"token tile ({x.shape[0] // bt})"
        )


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       tile_expert: torch.Tensor, *, bt: int,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``y[tile] = x[tile] @ w[tile_expert[tile]]`` in fp32, cast to
    ``out_dtype`` (default ``x.dtype``); the map on any device or the
    host.

    The tiles of one expert are multiplied together, one ``torch.matmul``
    per expert present, which is ``einsum("tbd,tdf->tbf", x_tiles,
    w[tile_expert])`` without materialising the gathered weights.
    """
    _check_shapes(x, w, tile_expert, bt)
    t, d = x.shape
    xt = x.reshape(t // bt, bt, d).float()
    te = torch.as_tensor(tile_expert).to(x.device, torch.int64)
    y = torch.empty((t // bt, bt, w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for e in torch.unique(te).tolist():
        sel = (te == e).nonzero().squeeze(1)
        y[sel] = torch.matmul(xt[sel], w[e].float())
    return y.reshape(t, -1).to(out_dtype or x.dtype)


def tile_pairs(tile_expert, bt: int) -> np.ndarray:
    """The kernel's work list: an int32 (P, 2) array of the first rows of
    two units of one expert each, the second -1 where an expert's units
    run out; every unit appears once.

    A unit is a ``UNIT_ROWS``-row sub-tile of a ``bt``-row token tile (a
    shorter tile is one unit).  Units are grouped by expert (stably, so in
    token order within an expert) and taken two at a time; the pairs come
    out ordered by expert, so blocks that run together share W's slices.
    ``tile_expert`` is a host array (numpy or a CPU tensor).
    """
    te = np.asarray(tile_expert, dtype=np.int64).reshape(-1)
    subs = -(-bt // UNIT_ROWS)
    starts = (np.arange(te.size, dtype=np.int64)[:, None] * bt
              + np.arange(subs, dtype=np.int64)[None, :] * UNIT_ROWS)
    experts = np.repeat(te, subs)
    order = np.argsort(experts, kind="stable")
    starts, experts = starts.reshape(-1)[order], experts[order]
    n = starts.size
    first = np.r_[True, experts[1:] != experts[:-1]] if n else np.zeros(0, bool)
    group_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    head = (np.arange(n) - group_start) % 2 == 0
    nxt = np.arange(n) + 1
    partnered = head & (nxt < n)
    partnered[partnered] &= experts[nxt[partnered]] == experts[partnered]
    second = np.full(n, -1, np.int64)
    second[partnered] = starts[nxt[partnered]]
    return np.stack([starts[head], second[head]], axis=1).astype(np.int32)


def host_to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory and
    without waiting for it (the copy is ordered on the current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def check_kernel_operands(x, w, tile_expert: torch.Tensor, bt: int) -> None:
    """The kernel's checks of its operands and its host tile map but their
    device (the shape-only route of ``kernels.ops`` runs them too)."""
    _check_shapes(x, w, tile_expert, bt)
    if x.dtype != w.dtype:
        raise TypeError(f"operand dtypes differ: {x.dtype} vs {w.dtype}")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"tile_expert must be int32, got {tile_expert.dtype}")
    if (x.stride(1) != 1 and x.shape[1] > 1) or (
            w.stride(2) != 1 and w.shape[2] > 1):
        raise ValueError(
            "grouped_gemm_cuda needs unit last strides of x and w (got "
            f"strides {x.stride()}, {w.stride()})"
        )
    if x.shape[0] >= 2**31:
        raise ValueError(
            f"the kernel indexes tokens in 32 bits, got T={x.shape[0]}")


def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor, tile_expert, *,
                      bt: int,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The grouped product through the CUDA kernel; counts its launches.

    ``x`` (T, D) and ``w`` (E, D, F) are float32 or bfloat16 CUDA tensors
    of one dtype with unit last stride (any row and expert strides);
    ``tile_expert`` is the int32 (T/bt,) tile map on the host (a numpy
    array or a CPU tensor, as ``kernels.ops.grouped_gemm`` gives it),
    whose entries lie in [0, E) — the caller checks that where it builds
    the map (``ops.grouped_gemm`` does); a tile naming no expert is never
    read and gives zeros.  The kernel's work list (``tile_pairs``) is
    built from the map there, and both are copied to the card without
    waiting for it.  The result is a new contiguous (T, F) tensor of
    ``out_dtype`` (default ``x.dtype``).
    """
    out_dtype = out_dtype or x.dtype
    if isinstance(tile_expert, torch.Tensor) and tile_expert.device.type != "cpu":
        raise ValueError(
            "grouped_gemm_cuda takes the tile map on the host, got one on "
            f"{tile_expert.device}"
        )
    host = torch.as_tensor(tile_expert)
    check_kernel_operands(x, w, host, bt)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(
            "grouped_gemm_cuda needs x and w on one CUDA device, got "
            f"{x.device} and {w.device}"
        )
    t, d = x.shape
    e, _, f = w.shape
    te = host_to_device(host.numpy(), x.device)
    pairs = host_to_device(tile_pairs(host, bt), x.device)
    y = torch.empty((t, f), dtype=out_dtype, device=x.device)
    err = _build.load().grouped_gemm_launch(
        x.data_ptr(), w.data_ptr(), te.data_ptr(),
        pairs.data_ptr(), y.data_ptr(), t, f, d, x.stride(0), w.stride(0),
        w.stride(1), bt, e, pairs.shape[0], _build.dtype_code(x.dtype),
        _build.dtype_code(out_dtype), _build.stream_handle(x.device),
    )
    _build.check(err, "grouped_gemm kernel launch")
    grouped_gemm_cuda.launches += 1
    return y


#: kernel launches so far (a plain integer; set it to 0 to start a count)
grouped_gemm_cuda.launches = 0
