"""The useful-work count, the kernels' work and the table of peaks.

The arithmetic of the program's ``mask_matmul_flops`` and
``rank_matmul_flops``, frozen here: a block-sparse product needs 2·b³
FLOP for each live (i, k, j) triple, i.e. a live (i, k) block of A and a
live (k, j) block of B; a dense or nonuniform product needs the compact
2·M·K·N; a rank-sparse A needs 2·r·(bm + bk)·N for each live block of
rank r.  A kernel's roofline counts the same work whatever implements
it: its operations at the card's peak against each input byte read once
and each output byte written once.
"""
from __future__ import annotations

import numpy as np

#: Published peaks (NVIDIA's data sheet, SXM part, dense, at 700 W), keyed
#: by ``torch.cuda.get_device_name()``.  ``flops`` is the bf16 tensor-core
#: peak: the port's fp32 kernels run as split-bf16 tensor-core products,
#: so no fp32-exact product on this card beats it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_per_s": 3.35e12},
}

FP32 = 4  # bytes


def dense_flop(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def live_triples(a_mask: np.ndarray, b_mask: np.ndarray) -> int:
    """The number of (i, k, j) with A[i, k] and B[k, j] both live."""
    a = np.asarray(a_mask, dtype=np.int64)
    b = np.asarray(b_mask, dtype=np.int64)
    return int((a.sum(axis=0) * b.sum(axis=1)).sum())


def blocksparse_flop(a_mask: np.ndarray, b_mask: np.ndarray,
                     block: int) -> float:
    return 2.0 * live_triples(a_mask, b_mask) * block ** 3


def rank_flop(ranks: np.ndarray, bm: int, bk: int, n: int) -> float:
    """A rank-sparse A times a dense B of ``n`` columns: each live block
    of rank r costs 2·r·(bm + bk)·n, or the dense block's 2·bm·bk·n where
    that is less."""
    r = np.asarray(ranks, np.int64)
    per = np.minimum(2.0 * r * (bm + bk), 2.0 * bm * bk) * (r > 0)
    return float(per.sum()) * n


def blocksparse_bytes(a_mask: np.ndarray, b_mask: np.ndarray,
                      block: int) -> float:
    """Each operand block that takes part in a live triple read once, each
    C block that some triple reaches written once, in fp32."""
    a = np.asarray(a_mask, bool)
    b = np.asarray(b_mask, bool)
    a_used = a & b.any(axis=1)[None, :]
    b_used = b & a.any(axis=0)[:, None]
    c_live = (a.astype(np.int64) @ b.astype(np.int64)) > 0
    blocks = int(a_used.sum()) + int(b_used.sum()) + int(c_live.sum())
    return float(blocks) * block * block * FP32


def tiled_bytes(m: int, k: int, n: int, launches: int) -> float:
    """``launches`` products that split K into panels: A and B read once,
    an (m, n) result written by each launch, in fp32."""
    return float(m * k + k * n + launches * m * n) * FP32


def least_seconds(flop: float, nbytes: float, peak: dict) -> float:
    """The larger of the compute and the memory bound."""
    return max(flop / peak["flops"], nbytes / peak["bytes_per_s"])
