"""Public wrappers for the hand-written kernels.

Handle shape padding, tile selection, dtype policy and the choice of path,
which follows the device of the operands and nothing else: a CUDA tensor
goes to the CUDA kernel (which raises if it cannot run), a CPU tensor to
the kernel's plain PyTorch version — the counterpart of the reference's
interpret mode, so the CPU tests check the same wrapper logic.

Operands are zero-padded to the tiles ``_pick_tile`` picks and the result
is cut back, exactly as the reference's ``repro.kernels.ops`` does; the
kernels then run their own 64 x 64 tiling and mask whatever edge is left.
``grouped_gemm``, ``ranksparse_matmul`` and ``flash_attention`` are not
ported yet (ROADMAP, queue B).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import block_csr_from_mask
from repro_torch.kernels.bsmm import bsmm_cuda, bsmm_plain
from repro_torch.kernels.tiled_matmul import (
    tiled_matmul_cuda,
    tiled_matmul_plain,
)

__all__ = ["tiled_matmul", "bsmm", "bsmm_cols"]


def _route(x: torch.Tensor, kernel, plain):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise RuntimeError(f"no kernel for tensors on {x.device}")


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
    """C = A @ B through the tiled kernel, auto-padded."""
    del accum_dtype  # the kernel always accumulates fp32
    m, k = a.shape
    _, n = b.shape
    bm = _pick_tile(m, bm)
    bk = _pick_tile(k, bk)
    bn = _pick_tile(n, bn)
    run = _route(a, tiled_matmul_cuda, tiled_matmul_plain)
    c = run(_pad2(a, (bm, bk)), _pad2(b, (bk, bn)), out_dtype)
    return c[:m, :n]


def bsmm_cols(
    a: torch.Tensor,
    b: torch.Tensor,
    cols: torch.Tensor,
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Block-sparse C = A @ B over a padded CSR column map (the call
    ``core.summa._exec_sparse_bsmm`` makes with ``plan.local_cols``)."""
    run = _route(a, bsmm_cuda, bsmm_plain)
    return run(a, b, cols, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)


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
    cols = torch.as_tensor(
        csr.padded_cols(max(csr.max_row_nnz, 1)), dtype=torch.int32,
        device=a.device,
    )
    bn = _pick_tile(n, bn)
    c = bsmm_cols(
        a, _pad2(b, (bk_sz, bn)), cols, bm=bm_sz, bk=bk_sz, bn=bn,
        out_dtype=out_dtype,
    )
    return c[:, :n]
