"""The paper's own experiment configurations (matrix multiplication).

Matrix sizes and blockings from §4: BG/Q weak/strong scaling used square
matrices N in {32768, 65536, 98304, 256000}; the commodity-cluster strong
scaling used N=32768 with block size 256 (uniform) and average 256
(nonuniform).  Copied from ``repro.configs.paper_mm``.

The system multiplies data rather than running a model, so it has no
weights: :func:`make_case` and :func:`make_rank_case` stand in for them.
They build the operands and block structure of one product from a seed
with numpy, so the tests can hand the same arrays to the JAX package and
to this one; :func:`make_nonuniform_case` builds the paper's nonuniformly
blocked product the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.blocking import Tiling, nonuniform_tiling
from repro_torch.core.sparsity import (
    RankCSR,
    decay_rank_map,
    random_block_mask,
    synthesize_rank_csr,
)

__all__ = [
    "PAPER_MATRIX_SIZES",
    "COMMODITY_N",
    "COMMODITY_BLOCK",
    "MMConfig",
    "BENCH_CONFIGS",
    "make_case",
    "make_nonuniform_case",
    "make_rank_factors",
    "make_rank_case",
]

PAPER_MATRIX_SIZES = (32_768, 65_536, 98_304, 256_000)
COMMODITY_N = 32_768
COMMODITY_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class MMConfig:
    n: int  # square matrix dimension
    block: int  # uniform block size (nonuniform: average)
    nonuniform: bool = False
    seed: int = 0

    @property
    def num_blocks(self) -> int:
        return self.n // self.block


# a scaled-down version of the commodity configuration (same structure);
# the reference's table has three more entries that nothing here runs
BENCH_CONFIGS = {
    "nonuniform_medium": MMConfig(n=4096, block=256, nonuniform=True),
}


def make_case(
    n: int, block: int, fill: float, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Operands and block masks of one square ``n x n`` product.

    Returns ``(a, b, a_mask, b_mask)``: float32 standard-normal operands
    drawn from ``np.random.default_rng(seed)`` (A first, then B) and
    ``(n/block, n/block)`` masks from ``random_block_mask`` at block fill
    ``fill`` (seeds ``seed + 1`` and ``seed + 2``; ``fill=1.0`` gives
    all-live masks).  The operands do not depend on ``fill``, so the dense
    and the block-sparse product of one seed share them.
    """
    if n % block:
        raise ValueError(f"n={n} is not a multiple of block={block}")
    nb = n // block
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    a_mask = random_block_mask(nb, nb, fill, seed=seed + 1)
    b_mask = random_block_mask(nb, nb, fill, seed=seed + 2)
    return a, b, a_mask, b_mask


def make_rank_factors(
    n: int, block: int, max_rank: int, seed: int = 0
) -> RankCSR:
    """A square ``n x n`` block-rank-sparse A stored as its factors.

    Block ranks decay away from the diagonal,
    ``decay_rank_map(n/block, n/block, block, block, max_rank=max_rank,
    decay=0.5, threshold=1e-2)`` (blocks below the threshold are absent),
    and ``synthesize_rank_csr(..., seed=seed)`` draws factors of exactly
    those ranks.  At the paper's commodity size (n = 32768, block 256,
    max_rank 64) 2342 of 16384 blocks are present, of mean rank 14.4.
    """
    if n % block:
        raise ValueError(f"n={n} is not a multiple of block={block}")
    nb = n // block
    rank_map = decay_rank_map(
        nb, nb, block, block, max_rank=max_rank, decay=0.5, threshold=1e-2
    )
    return synthesize_rank_csr(rank_map, seed=seed)


def make_rank_case(
    n: int, block: int, max_rank: int, seed: int = 0
) -> tuple[RankCSR, np.ndarray]:
    """Operands of one rank-sparse product: ``(a_ranks, b)``.

    ``a_ranks`` is :func:`make_rank_factors`; ``b`` is a float32
    standard-normal ``n x n`` matrix, the first draw of
    ``np.random.default_rng(seed)`` — the same array as :func:`make_case`'s
    A for that seed, so a caller that holds those operands can reuse it
    instead of drawing it again.
    """
    a_ranks = make_rank_factors(n, block, max_rank, seed)
    b = np.random.default_rng(seed).standard_normal((n, n), dtype=np.float32)
    return a_ranks, b


def make_nonuniform_case(
    n: int, avg_block: int, seed: int = 0
) -> tuple[tuple[Tiling, Tiling, Tiling], np.ndarray, np.ndarray]:
    """The paper's nonuniformly blocked ``n x n`` product (§4.1).

    Returns ``((row, inner, col), a, b)``: the three logical tilings
    ``nonuniform_tiling(n, n // avg_block, seed + s)`` for s = 0, 1, 2 (as
    the scheduler's command line builds them with ``--nonuniform``) and
    float32 standard-normal operands from ``np.random.default_rng(seed)``,
    A first — the same arrays as :func:`make_case`'s for that seed.
    """
    if n % avg_block:
        raise ValueError(f"n={n} is not a multiple of avg_block={avg_block}")
    tilings = tuple(
        nonuniform_tiling(n, n // avg_block, seed=seed + s) for s in range(3)
    )
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    return tilings, a, b
