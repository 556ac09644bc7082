"""Block-sparsity structure: masks, ranks, generators, and CSR-of-blocks.

The paper targets matrices that are "sparse in a general sense" — block
sparse with physics-driven structure (distance decay), not element sparse.
We model that with a boolean block mask over the logical block grid plus
generators for the structures named in the paper: random fill, banded
(local interactions), and exponential distance decay.

Its sequel (*Scalable Task-Based Algorithm for Multiplication of
Block-Rank-Sparse Matrices*, Calvin/Lewis/Valeev 2015) refines
present/absent blocks into **block-rank sparsity**: each surviving block
carries a numerical rank ``r`` and is stored factorized as ``U (bm x r)``
times ``V (r x bk)``, so a gemm task's cost follows the block's rank, not
its area.  ``BlockRankMap`` is the static rank structure, ``RankCSR`` the
factorized storage (CSR over blocks + stacked U/V panels).

``BlockCSR`` is the padded column-map layout consumed by the CUDA
block-sparse matmul kernel (kernels/bsmm.py); ``RankCSR`` is the factor
storage of the rank-sparse route, which this package plans but does not
execute yet.

A verbatim copy of ``repro.core.sparsity`` (pure numpy): the port keeps
its own so that it never imports the JAX package, and its tests hold the
two equal for equal seeds.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "random_block_mask",
    "banded_block_mask",
    "block_diag_block_mask",
    "decay_block_mask",
    "BlockCSR",
    "block_csr_from_mask",
    "mask_matmul_flops",
    "BlockRankMap",
    "RankCSR",
    "decay_rank_map",
    "random_rank_map",
    "rank_csr_from_dense",
    "synthesize_rank_csr",
    "block_rank_flops",
    "rank_panel_flops",
    "rank_panel_factored_comm",
    "rank_panel_factored_compute",
    "rank_matmul_flops",
    "block_norms",
    "rank_csr_norms",
    "norms_key",
]


def random_block_mask(
    m_blocks: int, n_blocks: int, fill: float, seed: int = 0
) -> np.ndarray:
    """Uniform random block mask with expected fill-in ``fill``.

    Guarantees every block row and column has at least one nonzero so the
    product stays full-rank-ish and load stats are well defined, and
    clamps the realized fill so the coverage fix-up cannot silently push
    it far past the request: surplus blocks are removed unless they are
    the sole support of their row or column, so ``mask.sum() <=
    max(ceil(fill * size), m_blocks + n_blocks)`` is guaranteed (every
    surviving surplus block uniquely covers a row or a column), and the
    typical realized count is ``max(ceil(fill * size), max(m_blocks,
    n_blocks))`` — previously a 1 x n grid at tiny fill came back dense.
    """
    if not 0.0 < fill <= 1.0:
        raise ValueError("fill must be in (0, 1]")
    rng = np.random.default_rng(seed)
    mask = rng.random((m_blocks, n_blocks)) < fill
    # ensure no empty row/col
    for i in range(m_blocks):
        if not mask[i].any():
            mask[i, rng.integers(n_blocks)] = True
    for j in range(n_blocks):
        if not mask[:, j].any():
            mask[rng.integers(m_blocks), j] = True
    # Clamp: on tiny grids / low fills the fix-up above (and Bernoulli
    # variance) can overshoot the request.  Remove surplus blocks that are
    # not the sole support of their row or column, in random order.
    target = max(
        math.ceil(fill * m_blocks * n_blocks), max(m_blocks, n_blocks)
    )
    surplus = int(mask.sum()) - target
    if surplus > 0:
        row_nnz = mask.sum(axis=1)
        col_nnz = mask.sum(axis=0)
        cand = np.argwhere(mask)
        for i, j in cand[rng.permutation(len(cand))]:
            if surplus <= 0:
                break
            if row_nnz[i] > 1 and col_nnz[j] > 1:
                mask[i, j] = False
                row_nnz[i] -= 1
                col_nnz[j] -= 1
                surplus -= 1
    return mask


def banded_block_mask(m_blocks: int, n_blocks: int, bandwidth: int) -> np.ndarray:
    """Banded structure: |i - j·(m/n)| <= bandwidth (local interactions)."""
    i = np.arange(m_blocks)[:, None]
    j = np.arange(n_blocks)[None, :]
    scale = m_blocks / n_blocks
    return np.abs(i - j * scale) <= bandwidth


def block_diag_block_mask(m_blocks: int, n_blocks: int) -> np.ndarray:
    """Block-diagonal structure: block (i, j) lives iff it sits on the
    (scaled) diagonal — the disconnected-fragment limit of a banded mask
    (``bandwidth=0``), named separately because SpGEMM products of two
    block-diagonal operands stay block-diagonal (closed under the
    symbolic product, the sharpest output-structure pruning case)."""
    return banded_block_mask(m_blocks, n_blocks, 0)


def _decay_factors(
    m_blocks: int, n_blocks: int, decay: float, threshold: float
) -> np.ndarray:
    """Validated exp(-decay·dist) grid shared by the decay mask and the
    decay rank map, so the two generators can never screen differently
    for the same parameters."""
    if m_blocks < 1 or n_blocks < 1:
        raise ValueError(
            f"block grid must be at least 1x1, got {m_blocks}x{n_blocks}"
        )
    if decay <= 0.0:
        raise ValueError(
            f"decay must be > 0 (got {decay}); non-positive decay never "
            "screens any block — use a dense (mask-free) product instead"
        )
    if not 0.0 < threshold < 1.0:
        raise ValueError(
            f"threshold must be in (0, 1) (got {threshold}); blocks are "
            "kept while exp(-decay*dist) > threshold, so threshold >= 1 "
            "keeps nothing and threshold <= 0 screens nothing"
        )
    i = np.arange(m_blocks)[:, None]
    j = np.arange(n_blocks)[None, :]
    scale = m_blocks / n_blocks
    return np.exp(-decay * np.abs(i - j * scale))


def decay_block_mask(
    m_blocks: int,
    n_blocks: int,
    decay: float = 0.5,
    threshold: float = 1e-2,
) -> np.ndarray:
    """Exponential distance decay screening: keep exp(-decay·|i-j|) > thr.

    Models the operator-kernel distance decay of the paper's quantum
    chemistry motivation (§1: block-sparsity "due to the distance decay of
    the operator kernel").
    """
    return _decay_factors(m_blocks, n_blocks, decay, threshold) > threshold


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """CSR over the *block* grid — the kernel-facing sparse map.

    ``row_ptr[i]:row_ptr[i+1]`` indexes ``col_idx`` with the nonzero block
    columns of block row ``i``.  ``max_row_nnz`` is the padded per-row
    iteration bound used by the static Pallas grid; rows shorter than the
    bound are padded with ``col_idx = -1`` sentinels in ``padded_cols``.
    """

    row_ptr: np.ndarray  # (M_blocks + 1,) int32
    col_idx: np.ndarray  # (nnz,) int32
    m_blocks: int
    n_blocks: int

    @property
    def nnz(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def max_row_nnz(self) -> int:
        return int(np.max(np.diff(self.row_ptr))) if self.nnz else 0

    def padded_cols(self, bound: int | None = None) -> np.ndarray:
        """(M_blocks, bound) int32, -1-padded nonzero columns per row."""
        bound = self.max_row_nnz if bound is None else bound
        out = np.full((self.m_blocks, bound), -1, dtype=np.int32)
        for i in range(self.m_blocks):
            cols = self.col_idx[self.row_ptr[i] : self.row_ptr[i + 1]]
            out[i, : len(cols)] = cols
        return out

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    def to_dense(self) -> np.ndarray:
        mask = np.zeros((self.m_blocks, self.n_blocks), dtype=bool)
        for i in range(self.m_blocks):
            mask[i, self.col_idx[self.row_ptr[i] : self.row_ptr[i + 1]]] = True
        return mask


def block_csr_from_mask(mask: np.ndarray) -> BlockCSR:
    mask = np.asarray(mask, dtype=bool)
    m_blocks, n_blocks = mask.shape
    row_ptr = np.zeros(m_blocks + 1, dtype=np.int32)
    cols: list[int] = []
    for i in range(m_blocks):
        nz = np.nonzero(mask[i])[0]
        cols.extend(int(c) for c in nz)
        row_ptr[i + 1] = len(cols)
    return BlockCSR(
        row_ptr=row_ptr,
        col_idx=np.asarray(cols, dtype=np.int32),
        m_blocks=m_blocks,
        n_blocks=n_blocks,
    )


def mask_matmul_flops(
    a_mask: np.ndarray, b_mask: np.ndarray, bm: int, bk: int, bn: int
) -> tuple[int, int]:
    """(sparse_flops, dense_flops) for C = A·B with uniform block sizes.

    A useful-work accounting used by benchmarks: a C block (i,j) needs a
    multiply for every k with A[i,k] and B[k,j] both nonzero.
    """
    a = np.asarray(a_mask, dtype=np.int64)
    b = np.asarray(b_mask, dtype=np.int64)
    pair_count = int((a @ b).sum())  # number of (i,k,j) nonzero triples
    sparse = 2 * pair_count * bm * bk * bn
    dense = 2 * a.shape[0] * a.shape[1] * b.shape[1] * bm * bk * bn
    return sparse, dense


# ---------------------------------------------------------------------------
# Block-rank sparsity (the sequel's refinement: low-rank *within* blocks)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockRankMap:
    """Static per-block numerical ranks over a uniform block grid.

    ``ranks[i, j]`` is the rank of block (i, j) of an (m_blocks*bm,
    k_blocks*bk) matrix; 0 means the block is screened out entirely (the
    plain block-sparse mask is the ``rank > 0`` special case with rank ==
    min(bm, bk)).  Ranks never exceed ``min(bm, bk)``.
    """

    ranks: np.ndarray  # (m_blocks, k_blocks) int32, 0 = absent block
    bm: int  # block row extent
    bk: int  # block column extent

    def __post_init__(self):
        ranks = np.asarray(self.ranks, dtype=np.int32)
        if ranks.ndim != 2:
            raise ValueError(f"ranks must be 2-D, got shape {ranks.shape}")
        if self.bm < 1 or self.bk < 1:
            raise ValueError(f"block extents must be >= 1, got ({self.bm},{self.bk})")
        cap = min(self.bm, self.bk)
        if (ranks < 0).any() or (ranks > cap).any():
            raise ValueError(
                f"ranks must lie in [0, min(bm, bk)={cap}]; got "
                f"[{int(ranks.min())}, {int(ranks.max())}]"
            )
        object.__setattr__(self, "ranks", ranks)

    @property
    def m_blocks(self) -> int:
        return int(self.ranks.shape[0])

    @property
    def k_blocks(self) -> int:
        return int(self.ranks.shape[1])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m_blocks * self.bm, self.k_blocks * self.bk)

    @property
    def mask(self) -> np.ndarray:
        """The present/absent block mask this rank structure refines."""
        return self.ranks > 0

    @property
    def max_rank(self) -> int:
        return int(self.ranks.max()) if self.ranks.size else 0

    @property
    def mean_rank(self) -> float:
        """Average rank over the *present* blocks (0 if none)."""
        nz = self.ranks[self.ranks > 0]
        return float(nz.mean()) if nz.size else 0.0


def decay_rank_map(
    m_blocks: int,
    k_blocks: int,
    bm: int,
    bk: int,
    *,
    max_rank: int | None = None,
    decay: float = 0.5,
    threshold: float = 1e-2,
) -> BlockRankMap:
    """Decay-structured ranks: r[i,j] ~ max_rank·exp(-decay·|i-j|).

    The rank analogue of :func:`decay_block_mask` — near-diagonal blocks
    are (nearly) full rank, far blocks decay smoothly and are screened out
    entirely once the decay factor drops below ``threshold``.  This is the
    structure operator kernels with distance decay produce after SVD
    truncation of each block.  Screening (``rank == 0``) coincides with
    :func:`decay_block_mask` for the same parameters by construction.
    """
    cap = min(bm, bk)
    max_rank = cap if max_rank is None else int(max_rank)
    if not 1 <= max_rank <= cap:
        raise ValueError(
            f"max_rank must be in [1, min(bm, bk)={cap}], got {max_rank}"
        )
    factor = _decay_factors(m_blocks, k_blocks, decay, threshold)
    ranks = np.where(
        factor > threshold,
        np.maximum(1, np.ceil(max_rank * factor)).astype(np.int32),
        np.int32(0),
    )
    return BlockRankMap(ranks=ranks, bm=bm, bk=bk)


def random_rank_map(
    m_blocks: int,
    k_blocks: int,
    bm: int,
    bk: int,
    fill: float,
    *,
    max_rank: int | None = None,
    seed: int = 0,
) -> BlockRankMap:
    """Random block mask with uniform random ranks in [1, max_rank]."""
    cap = min(bm, bk)
    max_rank = cap if max_rank is None else int(max_rank)
    if not 1 <= max_rank <= cap:
        raise ValueError(
            f"max_rank must be in [1, min(bm, bk)={cap}], got {max_rank}"
        )
    mask = random_block_mask(m_blocks, k_blocks, fill, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ranks = rng.integers(1, max_rank + 1, size=mask.shape, dtype=np.int32)
    return BlockRankMap(ranks=np.where(mask, ranks, 0), bm=bm, bk=bk)


def _pad_up(x: int, mult: int) -> int:
    return max(mult, -(-x // mult) * mult)


@dataclasses.dataclass(frozen=True)
class RankCSR:
    """Factorized block-rank-sparse storage: block CSR + stacked U/V panels.

    Block ``s`` of the CSR (block row ``i``, block column ``csr.col_idx[s]``)
    is stored as ``u[s] (bm x r_pad)`` times ``v[s] (r_pad x bk)`` with true
    rank ``ranks[s]``; factor columns/rows beyond the true rank are zero,
    so padded multiplication is exact.  ``r_pad`` is uniform across blocks
    (a multiple of 8 — the TPU f32 sublane — so factor panels tile
    cleanly); raggedness in the true ranks is carried by ``ranks`` and
    exploited by the per-panel widths of the rank-sparse executor and the
    grouped-gemm local kernel.
    """

    csr: BlockCSR
    ranks: np.ndarray  # (nnz,) int32 true rank per stored block
    u: np.ndarray  # (nnz, bm, r_pad) float32
    v: np.ndarray  # (nnz, r_pad, bk) float32
    bm: int
    bk: int

    def __post_init__(self):
        nnz = self.csr.nnz
        if self.ranks.shape != (nnz,):
            raise ValueError(f"ranks shape {self.ranks.shape} != ({nnz},)")
        if self.u.shape[:2] != (nnz, self.bm) or self.v.shape[0] != nnz:
            raise ValueError(
                f"factor shapes {self.u.shape}/{self.v.shape} do not match "
                f"nnz={nnz}, bm={self.bm}, bk={self.bk}"
            )
        if self.u.shape[2] != self.v.shape[1] or self.v.shape[2] != self.bk:
            raise ValueError(
                f"factor shapes {self.u.shape}/{self.v.shape} disagree on "
                f"r_pad/bk"
            )

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    @property
    def r_pad(self) -> int:
        return int(self.u.shape[2])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.csr.m_blocks * self.bm, self.csr.n_blocks * self.bk)

    def rank_map(self) -> BlockRankMap:
        """The static rank structure (dense grid of per-block ranks).
        Memoized — the instance is frozen, and plan-cache lookups call
        this on every matmul invocation."""
        cached = self.__dict__.get("_rank_map")
        if cached is None:
            ranks = np.zeros((self.csr.m_blocks, self.csr.n_blocks), np.int32)
            for i in range(self.csr.m_blocks):
                lo, hi = self.csr.row_ptr[i], self.csr.row_ptr[i + 1]
                ranks[i, self.csr.col_idx[lo:hi]] = self.ranks[lo:hi]
            cached = BlockRankMap(ranks=ranks, bm=self.bm, bk=self.bk)
            self.__dict__["_rank_map"] = cached
        return cached

    def to_dense(self) -> np.ndarray:
        """Reconstruct the dense-stored matrix (oracle / fallback path)."""
        m, k = self.shape
        out = np.zeros((m, k), dtype=self.u.dtype)
        for i in range(self.csr.m_blocks):
            lo, hi = self.csr.row_ptr[i], self.csr.row_ptr[i + 1]
            for s in range(lo, hi):
                j = int(self.csr.col_idx[s])
                out[i * self.bm : (i + 1) * self.bm,
                    j * self.bk : (j + 1) * self.bk] = self.u[s] @ self.v[s]
        return out


def rank_csr_from_dense(
    a: np.ndarray,
    bm: int,
    bk: int,
    *,
    tol: float = 1e-6,
    max_rank: int | None = None,
    pad_to: int = 8,
) -> RankCSR:
    """SVD-truncate each (bm, bk) block of ``a`` into a :class:`RankCSR`.

    A block keeps the singular values above ``tol`` times the matrix's
    largest singular value (and at most ``max_rank`` of them); blocks with
    no surviving singular value are absent from the structure.  The square
    roots of the singular values are folded into both factors so ``u`` and
    ``v`` stay balanced in magnitude.
    """
    a = np.asarray(a, dtype=np.float32)
    m, k = a.shape
    if m % bm or k % bk:
        raise ValueError(f"matrix {a.shape} not divisible by block ({bm},{bk})")
    cap = min(bm, bk)
    max_rank = cap if max_rank is None else min(int(max_rank), cap)
    m_blocks, k_blocks = m // bm, k // bk
    svds = {}
    s_max = 0.0
    for i in range(m_blocks):
        for j in range(k_blocks):
            blk = a[i * bm : (i + 1) * bm, j * bk : (j + 1) * bk]
            uu, ss, vt = np.linalg.svd(blk, full_matrices=False)
            svds[i, j] = (uu, ss, vt)
            if ss.size:
                s_max = max(s_max, float(ss[0]))
    cut = tol * s_max
    ranks_grid = np.zeros((m_blocks, k_blocks), np.int32)
    for (i, j), (_, ss, _) in svds.items():
        ranks_grid[i, j] = min(int((ss > cut).sum()), max_rank)
    csr = block_csr_from_mask(ranks_grid > 0)
    nnz = csr.nnz
    ranks = np.zeros(nnz, np.int32)
    r_pad = _pad_up(int(ranks_grid.max()) if nnz else 1, pad_to)
    u = np.zeros((nnz, bm, r_pad), np.float32)
    v = np.zeros((nnz, r_pad, bk), np.float32)
    for i in range(m_blocks):
        lo, hi = csr.row_ptr[i], csr.row_ptr[i + 1]
        for s in range(lo, hi):
            j = int(csr.col_idx[s])
            uu, ss, vt = svds[i, j]
            r = int(ranks_grid[i, j])
            ranks[s] = r
            root = np.sqrt(ss[:r])
            u[s, :, :r] = uu[:, :r] * root
            v[s, :r, :] = root[:, None] * vt[:r, :]
    return RankCSR(csr=csr, ranks=ranks, u=u, v=v, bm=bm, bk=bk)


def synthesize_rank_csr(
    rank_map: BlockRankMap, *, seed: int = 0, pad_to: int = 8
) -> RankCSR:
    """Random factorized matrix with *exactly* the given per-block ranks.

    Factors are drawn i.i.d. normal and scaled by 1/sqrt(r·bk) so block
    magnitudes stay O(1) regardless of rank — the synthetic workload the
    rank-sparsity benchmarks and the differential oracle sweep use.
    """
    rng = np.random.default_rng(seed)
    csr = block_csr_from_mask(rank_map.mask)
    nnz = csr.nnz
    bm, bk = rank_map.bm, rank_map.bk
    r_pad = _pad_up(rank_map.max_rank if nnz else 1, pad_to)
    ranks = np.zeros(nnz, np.int32)
    u = np.zeros((nnz, bm, r_pad), np.float32)
    v = np.zeros((nnz, r_pad, bk), np.float32)
    for i in range(rank_map.m_blocks):
        lo, hi = csr.row_ptr[i], csr.row_ptr[i + 1]
        for s in range(lo, hi):
            j = int(csr.col_idx[s])
            r = int(rank_map.ranks[i, j])
            ranks[s] = r
            scale = 1.0 / np.sqrt(r * bk)
            u[s, :, :r] = rng.normal(size=(bm, r)) * scale
            v[s, :r, :] = rng.normal(size=(r, bk))
    return RankCSR(csr=csr, ranks=ranks, u=u, v=v, bm=bm, bk=bk)


# ---------------------------------------------------------------------------
# Per-block Frobenius norms (DBCSR-style on-the-fly filtering support)
# ---------------------------------------------------------------------------


def block_norms(
    a: np.ndarray, m_blocks: int, k_blocks: int, *, mask: np.ndarray | None = None
) -> np.ndarray:
    """Per-block Frobenius norms of a dense-stored matrix.

    Returns an (m_blocks, k_blocks) float64 grid with ``norms[i, k] =
    ||A_ik||_F``; blocks outside ``mask`` (when given) are exactly 0 so a
    norm grid always refines its block mask (``norms > 0`` implies the
    mask).  This is the payload the DBCSR-style product filter
    (``plan_matmul(filter_eps=...)``) screens against: a gemm task (i, k,
    j) contributes at most ``||A_ik||_F * ||B_kj||_F`` to ``||C_ij||_F``
    (submultiplicativity of the Frobenius norm), so dropping every triple
    whose bound falls below threshold perturbs C by at most the *sum* of
    the dropped bounds — the additive error bound the planner records.
    """
    a = np.asarray(a, dtype=np.float64)
    m, k = a.shape
    if m % m_blocks or k % k_blocks:
        raise ValueError(
            f"matrix {a.shape} not divisible by block grid "
            f"({m_blocks},{k_blocks})"
        )
    bm, bk = m // m_blocks, k // k_blocks
    sq = a.reshape(m_blocks, bm, k_blocks, bk) ** 2
    norms = np.sqrt(sq.sum(axis=(1, 3)))
    if mask is not None:
        norms = np.where(np.asarray(mask, bool), norms, 0.0)
    return norms


def rank_csr_norms(rk: RankCSR) -> np.ndarray:
    """Per-block Frobenius norms of a factorized :class:`RankCSR`.

    ``||U_s V_s||_F^2 = <U_s^T U_s, V_s V_s^T>`` (trace of the product of
    the two r x r Grams), so the norms come out of r-sized contractions
    without reconstructing any bm x bk block.  Absent blocks are 0, same
    contract as :func:`block_norms`.
    """
    norms = np.zeros((rk.csr.m_blocks, rk.csr.n_blocks), np.float64)
    if rk.nnz:
        u = np.asarray(rk.u, np.float64)
        v = np.asarray(rk.v, np.float64)
        gram_u = np.einsum("smr,smt->srt", u, u)  # (nnz, r_pad, r_pad)
        gram_v = np.einsum("srk,stk->srt", v, v)
        sq = np.einsum("srt,srt->s", gram_u, gram_v)
        vals = np.sqrt(np.maximum(sq, 0.0))
        for i in range(rk.csr.m_blocks):
            lo, hi = rk.csr.row_ptr[i], rk.csr.row_ptr[i + 1]
            norms[i, rk.csr.col_idx[lo:hi]] = vals[lo:hi]
    return norms


def norms_key(norms: np.ndarray | None) -> str | None:
    """Stable content digest of a norm grid (plan-cache key component)."""
    if norms is None:
        return None
    import hashlib

    arr = np.ascontiguousarray(np.asarray(norms, np.float64))
    h = hashlib.sha1()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


#: executed-efficiency margin for the factored-compute decision: the
#: two-stage skinny-gemm pipeline sustains a lower fraction of peak than
#: one fused dense dot, so factored compute must win by this factor on
#: modeled FLOPs before the executor picks it (measured ~0.7-0.9 of dense
#: efficiency on CPU BLAS and MXU-tiled shapes; 0.85 flips only the
#: near-threshold panels).
RANK_COMPUTE_MARGIN = 0.85


def rank_panel_flops(
    r: int, bm: int, bk: int, bn: int
) -> tuple[float, float]:
    """(factored, densified) modeled FLOPs per block row of a width-``r``
    factor panel: factored ``U @ (V @ B)`` vs reconstruct-then-dense-dot."""
    factored = 2.0 * r * (bm + bk) * bn
    densified = 2.0 * bm * r * bk + 2.0 * bm * bk * bn
    return factored, densified


def rank_panel_factored_comm(r: int, bm: int, bk: int) -> bool:
    """Broadcast factors instead of the dense panel?  Pure bytes: a
    width-``r`` factor panel moves r·(bm+bk) elements per block row where
    the dense panel moves bm·bk — crossover at r* = bm·bk/(bm+bk).
    Shared by the planner's comm model, the task graph, and the executor.
    """
    return r * (bm + bk) < bm * bk


def rank_panel_factored_compute(r: int, bm: int, bk: int, bn: int) -> bool:
    """Run the factored two-stage contraction instead of a dense dot?
    FLOPs comparison with the ``RANK_COMPUTE_MARGIN`` efficiency factor.
    A panel can broadcast factors yet compute densely (receiver-side
    reconstruction) — the two decisions are independent."""
    factored, densified = rank_panel_flops(r, bm, bk, bn)
    return factored <= RANK_COMPUTE_MARGIN * densified


def block_rank_flops(r: int, bm: int, bk: int, bn: int) -> float:
    """Modeled FLOPs of one rank-``r`` block gemm against a (bk, bn) panel.

    The factored evaluation ``U @ (V @ B)`` costs ``2·r·bk·bn +
    2·bm·r·bn``; a block is executed densely (reconstruct-free, dense-
    stored operand) at ``2·bm·bk·bn`` when that is cheaper — the per-block
    ordering choice the rank-sparse executor makes per panel.
    """
    if r <= 0:
        return 0.0
    return float(min(2.0 * r * (bm + bk) * bn, 2.0 * bm * bk * bn))


def rank_matmul_flops(
    rank_map: BlockRankMap, b_mask: np.ndarray, bn: int
) -> tuple[float, int, int]:
    """(rank_flops, mask_flops, dense_flops) for C = A·B with A rank-sparse.

    ``rank_flops`` charges each live (i, k, j) triple the factored block
    cost (:func:`block_rank_flops`); ``mask_flops``/``dense_flops`` are the
    mask-only and dense accountings of :func:`mask_matmul_flops` for the
    same structure — the three-way comparison the benchmarks report.
    """
    b = np.asarray(b_mask, dtype=np.int64)
    if b.shape[0] != rank_map.k_blocks:
        raise ValueError(
            f"B row-blocks {b.shape[0]} != A col-blocks {rank_map.k_blocks}"
        )
    bm, bk = rank_map.bm, rank_map.bk
    # per-(i,k) factored cost, times the number of live j's for that k
    live_j = b.sum(axis=1)  # (k_blocks,)
    per_block = np.minimum(
        2.0 * rank_map.ranks * (bm + bk) * bn,
        2.0 * bm * bk * bn,
    ) * (rank_map.ranks > 0)
    rank_flops = float((per_block * live_j[None, :]).sum())
    mask_flops, dense_flops = mask_matmul_flops(
        rank_map.mask, b > 0, bm, bk, bn
    )
    return rank_flops, mask_flops, dense_flops
