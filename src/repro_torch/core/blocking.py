"""Tilings: uniform and nonuniform blockings of matrix dimensions.

The port of ``repro.core.blocking`` (numpy only; the same sizes for the
same seed, the same gather indices).  It reproduces the paper's data
model: a matrix dimension is split into logical blocks (possibly
nonuniform, "physics-driven" sizes), blocks are embedded cyclically onto
a process grid, and — because the matmul kernels want uniform tiles —
nonuniform logical blocks are *bucketed* into padded uniform physical
tiles with validity metadata.

Also implements the paper's §4.1 nonuniform block generation procedure and
§4.4 / Table 1 load-variability statistics.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Tiling",
    "uniform_tiling",
    "nonuniform_tiling",
    "paper_nonuniform_sizes",
    "cyclic_owner",
    "load_stats",
    "LoadStats",
    "bucketize",
    "BucketedTiling",
]


@dataclasses.dataclass(frozen=True)
class Tiling:
    """A blocking of one matrix dimension into contiguous logical blocks."""

    sizes: tuple[int, ...]  # size of each logical block, in elements

    def __post_init__(self):
        if len(self.sizes) == 0:
            raise ValueError("Tiling must have at least one block")
        if any(s <= 0 for s in self.sizes):
            raise ValueError(f"block sizes must be positive, got {self.sizes}")

    @property
    def extent(self) -> int:
        return int(sum(self.sizes))

    @property
    def num_blocks(self) -> int:
        return len(self.sizes)

    @property
    def offsets(self) -> tuple[int, ...]:
        """Start offset of each block."""
        return tuple(np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).tolist())

    @property
    def is_uniform(self) -> bool:
        return len(set(self.sizes)) == 1

    def block_of(self, index: int) -> int:
        """Logical block containing element ``index``."""
        if not 0 <= index < self.extent:
            raise IndexError(index)
        return int(np.searchsorted(np.cumsum(self.sizes), index, side="right"))


def uniform_tiling(extent: int, block: int) -> Tiling:
    """Uniform blocking; last block may be ragged if ``block`` ∤ ``extent``."""
    if extent <= 0 or block <= 0:
        raise ValueError("extent and block must be positive")
    full, rem = divmod(extent, block)
    sizes = (block,) * full + ((rem,) if rem else ())
    return Tiling(sizes)


def paper_nonuniform_sizes(
    extent: int, num_blocks: int, rng: np.random.Generator
) -> tuple[int, ...]:
    """The paper's §4.1 nonuniform block-size generation procedure.

    "we first start by constructing M empty row blocks ... we then randomly
    [add] one to the size [of] a row block, and repeat this step until the
    total number of rows among all blocks is equal to the number of rows in
    the uniformly blocked matrices."

    The paper notes a *low-quality* RNG was used deliberately to create
    significant inhomogeneity.  We bias the per-block row preference with
    a ±30 % uniform weight, which lands the min:max ratios in the paper's
    Table-1 band for its matrix sizes (memory ~1:3–1:4 as a 2-way block
    product, work ~1:4.5–1:7 as the 3-way task product).
    """
    if num_blocks <= 0 or extent < num_blocks:
        raise ValueError("need extent >= num_blocks >= 1")
    # Weighted preference per block — emulates the paper's "low-quality RNG"
    # bias.  Each block gets at least one row.
    weights = rng.uniform(0.9, 1.1, size=num_blocks)
    weights /= weights.sum()
    counts = rng.multinomial(extent - num_blocks, weights) + 1
    return tuple(int(c) for c in counts)


def nonuniform_tiling(
    extent: int, num_blocks: int, seed: int = 0
) -> Tiling:
    """Nonuniform tiling via the paper's generation procedure (§4.1)."""
    rng = np.random.default_rng(seed)
    return Tiling(paper_nonuniform_sizes(extent, num_blocks, rng))


def cyclic_owner(block_index: int | np.ndarray, num_procs: int):
    """Cyclic embedding of logical blocks onto a 1-D process group."""
    return block_index % num_procs


@dataclasses.dataclass(frozen=True)
class LoadStats:
    """Min:max load ratios as in the paper's Table 1 / §4.4."""

    memory_min_max: float  # max(mem)/min(mem) over units
    work_min_max: float  # max(work)/min(work) over units

    def as_row(self) -> str:
        return f"1:{self.memory_min_max:.2f}  1:{self.work_min_max:.2f}"


def load_stats(
    row_tiling: Tiling,
    col_tiling: Tiling,
    inner_tiling: Tiling | None = None,
    *,
    grid: tuple[int, int] | None = None,
) -> LoadStats:
    """Memory (elements of C) and work (FLOP) min:max ratios.

    With ``grid=None`` the statistic is per *block* (paper Table 1:
    block-level inhomogeneity).  With a ``(P_row, P_col)`` grid, blocks are
    cyclically embedded and the statistic is per *process* (paper §4.4:
    effective imbalance, e.g. the 1:1.35 claim for N=32768, P=256).
    """
    rows = np.asarray(row_tiling.sizes, dtype=np.int64)
    cols = np.asarray(col_tiling.sizes, dtype=np.int64)
    inner = (
        np.asarray(inner_tiling.sizes, dtype=np.int64)
        if inner_tiling is not None
        else cols  # square C = A·B: K blocking ~ N blocking
    )
    # memory: one C block, |C_ij| = m_i * n_j
    # work:   one task = one block triple (i, k, j): 2 * m_i * k_k * n_j
    #         (3-way product => wider spread than memory, cf. Table 1)
    mem = rows[:, None] * cols[None, :]
    k_total = int(inner.sum())
    if grid is None:
        work_ratio = float(
            (rows.max() * inner.max() * cols.max())
            / (rows.min() * inner.min() * cols.min())
        )
        return LoadStats(
            memory_min_max=float(mem.max() / mem.min()),
            work_min_max=work_ratio,
        )
    p_row, p_col = grid
    owners_r = np.arange(len(rows)) % p_row
    owners_c = np.arange(len(cols)) % p_col
    mem_per = np.zeros((p_row, p_col), dtype=np.float64)
    np.add.at(
        mem_per,
        (owners_r[:, None].repeat(len(cols), 1), owners_c[None, :].repeat(len(rows), 0)),
        mem,
    )
    work_per = mem_per * (2.0 * k_total)
    return LoadStats(
        memory_min_max=float(mem_per.max() / mem_per.min()),
        work_min_max=float(work_per.max() / work_per.min()),
    )


@dataclasses.dataclass(frozen=True)
class BucketedTiling:
    """Nonuniform logical blocks packed into uniform physical tiles.

    The matmul kernels want uniform tiles.  A nonuniform logical
    tiling is *bucketed*: each logical block is placed in ``ceil(size /
    tile)`` physical tiles; the final physical tile of a block is padded.
    ``valid`` records how many elements of each physical tile are real.

    This is the documented hardware adaptation of the paper's
    arbitrary-block-size support (README.md §Paper-to-code map).
    """

    logical: Tiling
    tile: int  # uniform physical tile size (e.g. 128/256)
    # Per physical tile: owning logical block and number of valid elements.
    block_id: tuple[int, ...]
    valid: tuple[int, ...]

    @property
    def num_tiles(self) -> int:
        return len(self.block_id)

    @property
    def padded_extent(self) -> int:
        return self.num_tiles * self.tile

    @property
    def padding_waste(self) -> float:
        """Fraction of physical elements that are padding."""
        return 1.0 - self.logical.extent / self.padded_extent

    def gather_indices(self) -> np.ndarray:
        """Map physical (padded) positions -> source positions (or -1 pad).

        Used to materialise the padded operand from the compact one with a
        single gather; -1 marks padding (caller substitutes zeros).
        """
        idx = np.full(self.padded_extent, -1, dtype=np.int64)
        offsets = self.logical.offsets
        pos = 0  # physical cursor
        for t in range(self.num_tiles):
            b = self.block_id[t]
            v = self.valid[t]
            # offset within the logical block for this tile:
            prior = sum(
                self.valid[u] for u in range(t) if self.block_id[u] == b
            )
            src0 = offsets[b] + prior
            idx[pos : pos + v] = np.arange(src0, src0 + v)
            pos += self.tile
        return idx


def bucketize(logical: Tiling, tile: int) -> BucketedTiling:
    """Pack a (possibly nonuniform) logical tiling into uniform tiles."""
    if tile <= 0:
        raise ValueError("tile must be positive")
    block_id: list[int] = []
    valid: list[int] = []
    for b, size in enumerate(logical.sizes):
        full, rem = divmod(size, tile)
        block_id.extend([b] * full)
        valid.extend([tile] * full)
        if rem:
            block_id.append(b)
            valid.append(rem)
    return BucketedTiling(
        logical=logical, tile=tile, block_id=tuple(block_id), valid=tuple(valid)
    )
