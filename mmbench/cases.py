"""The case makers: every input of a run, drawn from ``--seed``.

Frozen copies of the program's makers (``configs/paper_mm.py``:
``make_case``, ``make_nonuniform_case``; ``core/sparsity.py``:
``random_block_mask``; ``core/blocking.py``: ``paper_nonuniform_sizes``),
rewritten so that a later change to the program cannot change what is
measured.  Masks, tilings and the stream of choices are drawn on the host
with numpy; operands and the values of each fresh band on the card with a
``torch.Generator`` of the operands' device.

Each kind of draw has a stream of its own, so adding a draw to one kind
moves no other.  Any whole number is a seed: it is taken modulo 2**64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# one stream per kind of draw
A_VALUES, B_VALUES, A_MASK, B_MASK = 1, 2, 3, 4
TILING_ORDER = (5, 6, 7)  # rows, inner, cols
BAND_CHOICE, ROW_SAMPLE, PROJECTION, BAND_VALUES = 8, 9, 10, 11
A_FACTOR_V = 12  # A's right factors; its left ones take A_VALUES


def _entropy(seed: int, stream: int) -> list[int]:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, stream]


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """The host's generator of one stream of ``seed``."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, stream)))


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one stream of ``seed``."""
    state = np.random.SeedSequence(_entropy(seed, stream)).generate_state(
        2, np.uint32
    )
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31 | int(state[1]) >> 1) & ((1 << 63) - 1))
    return g


def normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard-normal float32 values on ``device`` in one call."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def operand(n: int, seed: int, stream: int, device) -> torch.Tensor:
    """A dense ``n x n`` float32 operand (``A_VALUES`` or ``B_VALUES``)."""
    return normal((n, n), device_generator(seed, stream, device), device)


def random_block_mask(m_blocks: int, n_blocks: int, fill: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Uniform random block mask of block fill ``fill``.

    The program's ``random_block_mask`` on a given generator: every block
    row and column keeps at least one live block, and surplus blocks that
    are not the sole support of their row or column are removed in random
    order down to ``max(ceil(fill * size), max(m_blocks, n_blocks))``.
    """
    if not 0.0 < fill <= 1.0:
        raise ValueError("fill must be in (0, 1]")
    mask = rng.random((m_blocks, n_blocks)) < fill
    for i in range(m_blocks):
        if not mask[i].any():
            mask[i, rng.integers(n_blocks)] = True
    for j in range(n_blocks):
        if not mask[:, j].any():
            mask[rng.integers(m_blocks), j] = True
    target = max(math.ceil(fill * m_blocks * n_blocks), max(m_blocks, n_blocks))
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


def paper_nonuniform_sizes(extent: int, num_blocks: int,
                           rng: np.random.Generator) -> tuple[int, ...]:
    """The paper's §4.1 nonuniform block sizes (the program's procedure):
    ``num_blocks`` blocks of at least one row each, the other rows dealt
    out by a multinomial over weights uniform in [0.9, 1.1]."""
    if num_blocks <= 0 or extent < num_blocks:
        raise ValueError("need extent >= num_blocks >= 1")
    weights = rng.uniform(0.9, 1.1, size=num_blocks)
    weights /= weights.sum()
    counts = rng.multinomial(extent - num_blocks, weights) + 1
    return tuple(int(c) for c in counts)


def nonuniform_sizes(n: int, num_blocks: int, sizes_seed: int,
                     seed: int) -> tuple[tuple[int, ...], ...]:
    """The row, inner and column block sizes of one nonuniform run.

    Each dimension's sizes are the paper's procedure at ``sizes_seed + s``
    (s = 0, 1, 2, as ``make_nonuniform_case`` seeds them), the same for
    every run; ``seed`` only permutes them.  So every seed pads to the
    same extents and does the same work, in another order.
    """
    out = []
    for s, stream in enumerate(TILING_ORDER):
        sizes = paper_nonuniform_sizes(
            n, num_blocks, np.random.default_rng(sizes_seed + s)
        )
        order = host_rng(seed, stream).permutation(num_blocks)
        out.append(tuple(sizes[i] for i in order))
    return tuple(out)


class BandStream:
    """The fresh band before each timed product: one band of ``rows`` rows
    of B, at a band drawn on the host, redrawn on the card.  Two streams
    made from one seed give the same bands in the same order."""

    def __init__(self, n: int, rows: int, seed: int, device):
        if n % rows:
            raise ValueError(f"band of {rows} rows does not divide n={n}")
        self.rows = rows
        self.bands = n // rows
        self._choice = host_rng(seed, BAND_CHOICE)
        self._values = device_generator(seed, BAND_VALUES, device)
        self._device = device

    def redraw(self, b: torch.Tensor) -> tuple[int, int]:
        """Redraw the next band of ``b`` in place; returns its rows."""
        lo = int(self._choice.integers(self.bands)) * self.rows
        b[lo:lo + self.rows] = normal(
            (self.rows, b.shape[1]), self._values, self._device
        )
        return lo, lo + self.rows


class RowStream:
    """The rows of each product's C that the check compares in full."""

    def __init__(self, n: int, count: int, seed: int):
        self.n, self.count = n, min(count, n)
        self._rng = host_rng(seed, ROW_SAMPLE)

    def next(self) -> np.ndarray:
        return np.sort(self._rng.choice(self.n, self.count, replace=False))


def projection(n: int, seed: int, device) -> torch.Tensor:
    """The vector x of the run: every product's C is checked as C @ x."""
    return normal((n,), device_generator(seed, PROJECTION, device), device)


def decay_ranks(m_blocks: int, k_blocks: int, max_rank: int, decay: float,
                threshold: float) -> np.ndarray:
    """Block ranks that decay away from the diagonal (the program's
    ``decay_rank_map``): ``ceil(max_rank * f)``, at least 1, where
    ``f = exp(-decay * |i - j * m_blocks / k_blocks|) > threshold``, else
    0 (the block is absent).  The same for every seed."""
    i = np.arange(m_blocks)[:, None]
    j = np.arange(k_blocks)[None, :]
    f = np.exp(-decay * np.abs(i - j * (m_blocks / k_blocks)))
    return np.where(f > threshold,
                    np.maximum(1, np.ceil(max_rank * f)).astype(np.int32),
                    np.int32(0))


def rank_factors(ranks: np.ndarray, block: int, seed: int, device,
                 pad_to: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The factors of each live block, in row-major block order: U
    ``(nnz, block, r_pad)`` scaled by ``1/sqrt(r * block)`` and V ``(nnz,
    r_pad, block)``, standard normal up to the block's rank r and zero
    beyond it (``synthesize_rank_csr``'s law, drawn on the card)."""
    r = torch.as_tensor(ranks[ranks > 0], device=device)
    r_pad = -(-int(ranks.max()) // pad_to) * pad_to
    nnz = r.numel()
    keep = torch.arange(r_pad, device=device)[None, :] < r[:, None]
    u = normal((nnz, block, r_pad), device_generator(seed, A_VALUES, device),
               device)
    v = normal((nnz, r_pad, block), device_generator(seed, A_FACTOR_V, device),
               device)
    u *= keep[:, None, :] / torch.sqrt(r.to(torch.float32) * block)[:, None, None]
    v *= keep[:, :, None]
    return u, v
