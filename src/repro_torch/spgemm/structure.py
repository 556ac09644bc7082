"""Symbolic structure algebra for sparse x sparse (SpGEMM) products.

The planner historically let only A's structure drive pruning; genuinely
sparse workloads need the full A.B.C structure *triple* (ROADMAP item 1).
This module is the single source of truth for the symbolic pieces:

* :func:`output_mask` — the boolean block product ``c = a (.) b`` that
  every layer (``plan_matmul``'s dead-output pruning, ``contract()``'s
  inferred result masks) derives the C structure from, so the planner and
  the contraction front-end can never disagree;
* :func:`output_rank_bound` — the rank-aware refinement: a sum of
  per-addend rank bounds ``min(r_a[i,k], r_b[k,j])``, since the rank of a
  sum of products is at most the sum of the factor ranks;
* :func:`live_elems` — the modeled element volume a structure moves when
  its operand travels, the common currency of the stationarity chooser
  (factored blocks charge their factor footprint, mirroring
  ``sparsity.rank_panel_factored_comm``).

Structure operands are duck-typed: ``None`` (dense), a boolean/integer
block mask, a ``BlockRankMap``, or a ``RankCSR`` — rank structures
contribute their ``rank > 0`` support (rank 0 = screened out).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sparsity import BlockRankMap, RankCSR

__all__ = [
    "as_block_mask",
    "as_rank_grid",
    "output_mask",
    "output_rank_bound",
    "live_elems",
    "filter_keep",
    "output_norms",
]


def as_block_mask(
    structure, blocks: tuple[int, int] | None = None
) -> np.ndarray | None:
    """Normalize a structure operand to a boolean block mask.

    ``None`` stays ``None`` unless ``blocks`` gives the grid to synthesize
    all-ones on; rank structures (``BlockRankMap`` / ``RankCSR``) map to
    their ``rank > 0`` support; anything array-like is cast to bool.
    """
    if structure is None:
        if blocks is None:
            return None
        return np.ones(blocks, dtype=bool)
    if isinstance(structure, RankCSR):
        return np.asarray(structure.rank_map().mask, dtype=bool)
    if isinstance(structure, BlockRankMap):
        return np.asarray(structure.mask, dtype=bool)
    return np.asarray(structure, dtype=bool)


def as_rank_grid(structure) -> np.ndarray | None:
    """The per-block rank grid of a structure operand, or ``None`` when it
    carries no rank information (plain masks are rank-blind)."""
    if isinstance(structure, RankCSR):
        structure = structure.rank_map()
    if isinstance(structure, BlockRankMap):
        return np.asarray(structure.ranks, dtype=np.int64)
    return None


def output_mask(
    a_structure,
    b_structure,
    *,
    m_blocks: int | None = None,
    n_blocks: int | None = None,
) -> np.ndarray | None:
    """Symbolic output structure ``c = a (.) b`` (boolean block product).

    ``c[i, j]`` is live iff some panel ``kk`` has both ``a[i, kk]`` and
    ``b[kk, j]`` live — exactly the blocks a sparse x sparse product can
    populate.  One-sided inputs broadcast the surviving row/column support
    over the dense side's grid (``m_blocks`` / ``n_blocks``, default 1);
    two dense sides return ``None`` (a dense product has no structure to
    feed back).  Rank structures contribute their ``rank > 0`` support.
    """
    am = as_block_mask(a_structure)
    bm = as_block_mask(b_structure)
    if am is None and bm is None:
        return None
    if am is None:
        live_col = bm.any(axis=0)  # (N_blk,) columns reachable at all
        mb = 1 if m_blocks is None else int(m_blocks)
        return np.broadcast_to(live_col[None, :], (mb, bm.shape[1])).copy()
    if bm is None:
        live_row = am.any(axis=1)  # (M_blk,) rows with any contribution
        nb = 1 if n_blocks is None else int(n_blocks)
        return np.broadcast_to(live_row[:, None], (am.shape[0], nb)).copy()
    if am.shape[1] != bm.shape[0]:
        raise ValueError(
            f"A col-blocks ({am.shape[1]}) must equal B row-blocks "
            f"({bm.shape[0]})"
        )
    return (am.astype(np.int64) @ bm.astype(np.int64)) > 0


def output_rank_bound(a_structure, b_structure) -> np.ndarray | None:
    """Rank-aware output structure: an upper bound on each C block's rank.

    ``rank(C[i,j]) <= sum_k min(rank(A[i,k]), rank(B[k,j]))`` — each
    addend ``A[i,k] @ B[k,j]`` has rank at most the smaller factor rank,
    and ranks are subadditive over the sum.  Plain masks enter as rank-1*
    support in the sense of "unbounded": a masked (non-rank) operand
    contributes ``min`` with infinity, i.e. the other side's rank, or 1
    per addend when neither side carries ranks.  Returns ``None`` when
    neither side has block structure at all.
    """
    am = as_block_mask(a_structure)
    bm = as_block_mask(b_structure)
    if am is None or bm is None:
        return None
    ra = as_rank_grid(a_structure)
    rb = as_rank_grid(b_structure)
    big = np.int64(np.iinfo(np.int32).max)
    ra = np.where(am, big, 0) if ra is None else np.asarray(ra, np.int64)
    rb = np.where(bm, big, 0) if rb is None else np.asarray(rb, np.int64)
    if ra.shape[1] != rb.shape[0]:
        raise ValueError(
            f"A col-blocks ({ra.shape[1]}) must equal B row-blocks "
            f"({rb.shape[0]})"
        )
    per = np.minimum(ra[:, :, None], rb[None, :, :])  # (M, K, N) addends
    per = np.minimum(per, big)  # mask x mask addends stay bounded
    per = np.where(per == big, 1, per)
    return per.sum(axis=1)


def filter_keep(
    a_norms: np.ndarray, b_norms: np.ndarray, filter_eps: float
) -> tuple[np.ndarray, float]:
    """DBCSR-style product screening on per-block Frobenius norms.

    ``keep[i, k, j]`` is True iff the (i, k, j) gemm's contribution bound
    ``||A_ik||_F * ||B_kj||_F`` reaches ``filter_eps`` (dead blocks — norm
    0 — never survive).  Returns ``(keep, bound)`` where ``bound`` is the
    sum of the dropped nonzero products: by submultiplicativity and the
    triangle inequality, executing only the kept triples perturbs C by at
    most ``bound`` in Frobenius norm — the additive error bound
    ``plan_matmul`` records as ``filter_bound``.  ``keep`` shrinks
    monotonically in ``filter_eps``, so task counts are monotone too.
    """
    a = np.asarray(a_norms, np.float64)
    b = np.asarray(b_norms, np.float64)
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"A col-blocks ({a.shape[1]}) must equal B row-blocks "
            f"({b.shape[0]})"
        )
    prod = a[:, :, None] * b[None, :, :]  # (M, K, N) contribution bounds
    keep = prod >= float(filter_eps)
    keep &= prod > 0.0
    bound = float(prod[(~keep) & (prod > 0.0)].sum())
    return keep, bound


def output_norms(
    a_norms: np.ndarray,
    b_norms: np.ndarray,
    keep: np.ndarray | None = None,
) -> np.ndarray:
    """Propagated per-block norm *bounds* for ``C = A . B``.

    ``||C_ij||_F <= sum_k ||A_ik||_F * ||B_kj||_F`` — the norm grids
    multiply like the matrices themselves.  With ``keep`` (a ``(M, K, N)``
    screening tensor from :func:`filter_keep`) only surviving triples
    contribute, so iterative chains see the *filtered* predecessor
    structure, not the symbolic product: a C block all of whose addends
    were screened carries bound 0 and drops out of the next product
    entirely (progressive sparsification, the chain regression pins this).
    """
    a = np.asarray(a_norms, np.float64)
    b = np.asarray(b_norms, np.float64)
    if keep is None:
        return a @ b
    prod = a[:, :, None] * b[None, :, :]
    return np.where(keep, prod, 0.0).sum(axis=1)


def live_elems(structure, shape: tuple[int, int]) -> float:
    """Modeled element count this operand moves when it travels.

    Dense (``None``) charges the full extent; masks charge live blocks at
    their dense block area; rank structures charge each live block
    ``min(r * (bm + bk), bm * bk)`` — factors travel while they are the
    smaller representation, the same per-block crossover the rank
    executors take (``sparsity.rank_panel_factored_comm``).
    """
    rows, cols = int(shape[0]), int(shape[1])
    if structure is None:
        return float(rows * cols)
    ranks = as_rank_grid(structure)
    mask = as_block_mask(structure)
    rb, cb = mask.shape
    if rows % rb or cols % cb:
        raise ValueError(
            f"structure grid {mask.shape} must evenly block ({rows},{cols})"
        )
    br, bc = rows // rb, cols // cb
    if ranks is None:
        return float(mask.sum()) * br * bc
    r = ranks[mask]
    return float(np.minimum(r * (br + bc), br * bc).sum())
