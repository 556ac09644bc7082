"""The paper's own experiment configurations (matrix multiplication).

Matrix sizes and blockings from §4: BG/Q weak/strong scaling used square
matrices N in {32768, 65536, 98304, 256000}; the commodity-cluster strong
scaling used N=32768 with block size 256 (uniform) and average 256
(nonuniform).  Copied from ``repro.configs.paper_mm``.

The system multiplies data rather than running a model, so it has no
weights: :func:`make_case` stands in for them.  It builds the operands and
block masks of one product from a seed with numpy, so the tests can hand
the same arrays to the JAX package and to this one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sparsity import random_block_mask

__all__ = [
    "PAPER_MATRIX_SIZES",
    "COMMODITY_N",
    "COMMODITY_BLOCK",
    "MMConfig",
    "make_case",
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
