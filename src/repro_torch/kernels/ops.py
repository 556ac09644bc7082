"""Public wrappers for the four hand-written kernels: ``tiled_matmul``,
``bsmm`` (and ``bsmm_cols``), ``grouped_gemm`` (and ``ranksparse_matmul``
built on it) and ``flash_attention``.

Handle shape padding, tile selection, dtype policy and the choice of path,
which follows the device of the operands and nothing else: a CUDA tensor
goes to the CUDA kernel (which raises if it cannot run), a CPU tensor to
the kernel's plain PyTorch version — the counterpart of the reference's
interpret mode, so the CPU tests check the same wrapper logic.

The CUDA kernels run their own tiling and mask every ragged edge, so a
CUDA operand goes to its kernel unpadded.  On the CPU route
``tiled_matmul`` and ``bsmm`` zero-pad to the tiles ``_pick_tile`` picks
and cut the result back, exactly as the reference's ``repro.kernels.ops``
does.  Index maps (``bsmm``'s column map, ``grouped_gemm``'s tile
experts) are taken as host arrays, checked there, and moved to the
operands' device, so a launch never waits on the card to check them.
``flash_attention`` launches its kernel for every CUDA tensor, whatever
the sequence length: the kernel masks a ragged tail, so the reference's
fall-back to plain attention for lengths off the tile is not needed.

A ``meta`` tensor takes a shape-only route: the wrapper's host checks,
then an empty result of the kernel's shape and dtype, so a step can be
counted without a card (``analysis.cost``).  Each wrapper reports its
function's work to the active ``analysis.cost.CostCounter`` and suspends
it inside, so the three routes count the same: ``tiled_matmul`` 2·M·N·K
FLOP, ``bsmm`` 2·bm·bk·N per live block of its column map (2·bm·bk
per column of the tile a list of a tile map covers),
``grouped_gemm`` 2·bt·D·F per tile, ``flash_attention`` 4·B·H·Sq·Sk·Dh
(the plain route's two products); bytes, the operands and the result.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.cost import kernel_call
from repro_torch.core.sparsity import block_csr_from_mask
from repro_torch.kernels import bsmm as _bsmm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import tiled_matmul as _tm
from repro_torch.kernels.bsmm import bsmm_cuda, bsmm_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.grouped_gemm import (
    grouped_gemm_cuda,
    grouped_gemm_plain,
)
from repro_torch.kernels.tiled_matmul import (
    tiled_matmul_cuda,
    tiled_matmul_plain,
)

__all__ = [
    "tiled_matmul", "bsmm", "bsmm_cols", "grouped_gemm", "ranksparse_matmul",
    "flash_attention",
]


def _route(x: torch.Tensor, kernel, plain, meta):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    if x.device.type == "meta":
        return meta
    raise RuntimeError(f"no kernel for tensors on {x.device}")


# -- shape-only routes (meta tensors): the kernels' checks and results ------


def _tiled_matmul_meta(a, b, out_dtype=None):
    _tm.check_kernel_operands(a, b)
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype or a.dtype)


def _bsmm_meta(a, b, cols, *, bm, bk, bn, out_dtype=None):
    _bsmm.check_kernel_operands(a, b, cols, bm, bk, bn)
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype or a.dtype)


def _grouped_gemm_meta(x, w, tile_expert, *, bt, out_dtype=None):
    _gg.check_kernel_operands(x, w, torch.as_tensor(tile_expert), bt)
    return x.new_empty((x.shape[0], w.shape[2]), dtype=out_dtype or x.dtype)


def _flash_attention_meta(q, k, v, *, causal, window, scale):
    del causal, window, scale
    _fa.check_kernel_operands(q, k, v)
    return torch.empty_like(q)


def _pad2(x: torch.Tensor, mults) -> torch.Tensor:
    pads = [-(-d // m) * m - d for d, m in zip(x.shape, mults)]
    if any(pads):
        return F.pad(x, (0, pads[1], 0, pads[0]))
    return x


def _pick_tile(dim: int, pref: int) -> int:
    """Largest power-of-two tile <= pref that keeps padding reasonable."""
    t = pref
    while t > 8 and dim % t and dim < t:
        t //= 2
    return max(t, 8)


def tiled_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int = 256,
    bk: int = 256,
    bn: int = 256,
    accum_dtype=torch.float32,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """C = A @ B through the tiled kernel (auto-padded on the CPU route)."""
    del accum_dtype  # the kernel always accumulates fp32
    run = _route(a, tiled_matmul_cuda, tiled_matmul_plain, _tiled_matmul_meta)
    m, k = a.shape
    n = b.shape[1]
    with kernel_call("tiled_matmul", a.device) as call:
        if run is not tiled_matmul_plain:  # the kernel masks ragged edges
            c = run(a, b, out_dtype)
        else:
            bm = _pick_tile(m, bm)
            bk = _pick_tile(k, bk)
            bn = _pick_tile(n, bn)
            c = run(_pad2(a, (bm, bk)), _pad2(b, (bk, bn)), out_dtype)[:m, :n]
        call.report(2.0 * m * n * k, (a, b), (c,))
    return c


def bsmm_columns(cols: np.ndarray, k_blocks: int, n: int) -> float:
    """The columns of C that ``bsmm`` multiplies over a column map, summed
    over its listed entries (each list's prefix of valid entries: N for a
    list of A's block row, the width of its tile for a list of a tile
    map); 2·bm·bk times this is the kernel's FLOP.  Refuses, on the host,
    a map that names a block column at or past ``k_blocks`` (it would
    read past A)."""
    cols = np.asarray(cols, dtype=np.int32)
    if cols.size and int(cols.max()) >= k_blocks:
        raise ValueError(f"col map names a block column >= K/bk={k_blocks}")
    listed = np.logical_and.accumulate(cols >= 0, axis=-1)
    if cols.ndim == 3:
        width = np.minimum(_bsmm.TILE_COLS,
                           n - _bsmm.TILE_COLS * np.arange(cols.shape[1]))
        return float(listed.sum(axis=(0, 2)) @ width)
    return float(listed.sum()) * n


def bsmm_cols(
    a: torch.Tensor,
    b: torch.Tensor,
    cols: np.ndarray,
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype: torch.dtype | None = None,
    device_cols: torch.Tensor | None = None,
    columns: float | None = None,
) -> torch.Tensor:
    """Block-sparse C = A @ B over a padded CSR column map (the call
    ``core.summa._exec_sparse_bsmm`` makes with this rank's map): one list
    a block row, (M/bm, S), or one a block row and 256-column tile of C,
    (M/bm, ceil(N/256), S).

    ``cols`` is a host array (numpy or a CPU tensor); it is checked and
    counted here, on the host (``bsmm_columns``), and moved to ``a``'s
    device, unless the caller holds both already: that copy
    (``device_cols``: int32, on ``a``'s device) and ``bsmm_columns``'
    count of the same map (``columns``)."""
    run = _route(a, bsmm_cuda, bsmm_plain, _bsmm_meta)
    if device_cols is None or columns is None:
        columns = bsmm_columns(cols, a.shape[1] // bk, b.shape[1])
        device_cols = torch.as_tensor(np.asarray(cols, dtype=np.int32),
                                      device=a.device)
    with kernel_call("bsmm", a.device) as call:
        c = run(a, b, device_cols, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
        call.report(2.0 * bm * bk * columns, (a, b, device_cols), (c,))
    return c


def bsmm(
    a: torch.Tensor,
    b: torch.Tensor,
    mask: np.ndarray,
    *,
    bn: int = 256,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Block-sparse C = A @ B; ``mask`` is the (M_blk, K_blk) block mask.

    Block sizes are derived from the mask grid; A's shape must divide the
    mask evenly.  Zero block rows produce zero C rows.
    """
    m, k = a.shape
    _, n = b.shape
    mask = np.asarray(mask, bool)
    mb, kb = mask.shape
    if m % mb or k % kb:
        raise ValueError(
            f"operand {tuple(a.shape)} not divisible by mask {mask.shape}"
        )
    bm_sz, bk_sz = m // mb, k // kb
    csr = block_csr_from_mask(mask)
    cols = csr.padded_cols(max(csr.max_row_nnz, 1))
    bn = _pick_tile(n, bn)
    c = bsmm_cols(
        a, _pad2(b, (bk_sz, bn)), cols, bm=bm_sz, bk=bk_sz, bn=bn,
        out_dtype=out_dtype,
    )
    return c[:, :n]


def grouped_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    tile_expert,
    *,
    bt: int = 256,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Tile-aligned grouped GEMM: ``y[tile] = x[tile] @ w[tile_expert[tile]]``
    over ``bt``-row tiles of ``x`` (T, D), experts ``w`` (E, D, F).

    ``tile_expert`` is a host array (numpy or a CPU tensor) of T/bt expert
    indices; it is checked here and handed on on the host, where the
    kernel's wrapper builds its work list and from where it copies the map
    to the card, so the launch never waits for the card.  The
    reference's ``bk``/``bn`` tile choices have no counterpart: the kernel
    tiles D and F itself and masks their edges, so nothing is padded.
    """
    t = x.shape[0]
    if t % bt:
        raise ValueError(f"token count {t} must divide tile {bt}")
    run = _route(x, grouped_gemm_cuda, grouped_gemm_plain, _grouped_gemm_meta)
    te = np.asarray(tile_expert, dtype=np.int32)
    if te.size and (int(te.min()) < 0 or int(te.max()) >= w.shape[0]):
        raise ValueError(
            f"tile_expert names an expert outside [0, {w.shape[0]})"
        )
    with kernel_call("grouped_gemm", x.device) as call:
        y = run(x, w, te, bt=bt, out_dtype=out_dtype)
        call.report(2.0 * t * x.shape[1] * w.shape[2], (x, w), (y,),
                    extra_bytes=te.nbytes)
    return y


def ranksparse_matmul(
    a_ranks,
    b: torch.Tensor,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Local C = A @ B with A block-rank-sparse (a ``RankCSR``).

    Stage 1, every stored block's ``V[s] @ B_panel[col_idx[s]]``, is ONE
    grouped-GEMM launch: the stacked V rows are the tokens, each
    ``r_pad``-row tile's expert is its block's K panel, read in place from
    B viewed ``(K/bk, bk, N)``.  Stage 2 applies the U factors per block
    and sums the partial products into C's block rows (``index_add_``, the
    reference's ``segment_sum``).  FLOPs scale with ``nnz · r_pad``, not
    the dense shape.  B is promoted to the factors' type, as JAX promotes
    fp32 factors times a bf16 B; the result has ``out_dtype`` (default
    B's dtype).
    """
    k, n = b.shape
    bm, bk = a_ranks.bm, a_ranks.bk
    csr = a_ranks.csr
    if k != csr.n_blocks * bk:
        raise ValueError(f"B rows {k} != rank structure K {csr.n_blocks * bk}")
    out_dtype = out_dtype or b.dtype
    m = csr.m_blocks * bm
    if csr.nnz == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=b.device)
    r_pad = a_ranks.r_pad
    v = torch.as_tensor(a_ranks.v, device=b.device)
    u = torch.as_tensor(a_ranks.u, device=b.device)
    b_panels = b.to(torch.promote_types(v.dtype, b.dtype)).reshape(
        csr.n_blocks, bk, n
    )
    y = grouped_gemm(
        v.to(b_panels.dtype).reshape(csr.nnz * r_pad, bk), b_panels,
        csr.col_idx, bt=r_pad, out_dtype=torch.float32,
    )
    partials = torch.bmm(u.float(), y.view(csr.nnz, r_pad, n))
    row_ids = torch.as_tensor(
        np.repeat(np.arange(csr.m_blocks), csr.row_lengths()),
        device=b.device,
    )
    c = torch.zeros((csr.m_blocks, bm, n), dtype=torch.float32,
                    device=b.device)
    c.index_add_(0, row_ids, partials)
    return c.reshape(m, n).to(out_dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    bq: int = 256,
    bk: int = 256,
) -> torch.Tensor:
    """Tiled online-softmax attention (forward) of ``q`` (B, H, S, Dh) over
    ``k``, ``v`` (B, Hkv, S, Dh).

    ``bq``/``bk`` are the reference's Pallas tile and have no counterpart:
    the CUDA kernel runs its own query and key tiles (bf16: 128 rows and
    64 keys; fp32: 64 rows, keys 64 or 32 at Dh = 256) and masks the
    ragged tail, so any S launches it.  It takes any head width from 1 to
    256, on its instance for the next of 64, 128 and 256 with the columns
    past Dh read as zero; a wider head raises.
    """
    del bq, bk  # the kernel tiles itself
    run = _route(q, flash_attention_cuda, flash_attention_plain,
                 _flash_attention_meta)
    b, h, sq, dh = q.shape
    with kernel_call("flash_attention", q.device) as call:
        o = run(q, k, v, causal=causal, window=window, scale=scale)
        call.report(4.0 * b * h * sq * k.shape[2] * dh, (q, k, v), (o,))
    return o
