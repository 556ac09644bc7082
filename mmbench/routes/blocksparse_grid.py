"""Block-sparse A and B, as ``blocksparse``, through ``DistributedMatmul``
on a grid of ranks, one card each (``multirank``): each rank cuts its tiles
of the global operands, broadcasts the live K panels along its grid row and
column, runs one ``bsmm`` launch over its tile of C, and gathers the whole
C."""
from __future__ import annotations

import numpy as np

from mmbench import cases, count
from mmbench.routes import UniformProgram
from mmbench.routes.blocksparse import (  # noqa: F401 (a route's hooks)
    operand_a, reference_a, reference_b_rows, useful_flop)


def _within_groups(order: np.random.Generator, size: int, groups: int):
    """A permutation of ``range(size)`` that keeps each of ``groups`` equal
    runs of it in place, shuffling inside each."""
    run = size // groups
    return np.concatenate([g * run + order.permutation(run)
                           for g in range(groups)])


def structure(cfg, traffic, seed) -> dict:
    """``blocksparse``'s mask pair at the traffic's ``mask_seed``; the seed
    permutes the contraction's blocks freely, but A's block rows only
    within each grid row's share and B's block columns only within each
    grid column's.  So every seed gives each rank the same live triples,
    and the slowest rank, which sets the product's pace, the same work."""
    nb = cfg["n"] // cfg["block"]
    p, q = cfg["grid"]
    a = cases.random_block_mask(nb, nb, traffic["a_fill"],
                                cases.host_rng(traffic["mask_seed"], cases.A_MASK))
    b = cases.random_block_mask(nb, nb, traffic["b_fill"],
                                cases.host_rng(traffic["mask_seed"], cases.B_MASK))
    order = cases.host_rng(seed, cases.A_MASK)
    rows = _within_groups(order, nb, p)
    inner = order.permutation(nb)
    cols = _within_groups(order, nb, q)
    return {"a_mask": a[rows][:, inner], "b_mask": b[inner][:, cols]}


def rank_share(cfg, st, rank: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The masks of A's block rows and B's block columns that ``rank`` of
    the row-major grid multiplies."""
    p, q = cfg["grid"]
    i, j = divmod(rank, q)
    mb, nb = st["a_mask"].shape[0] // p, st["b_mask"].shape[1] // q
    return (st["a_mask"][i * mb:(i + 1) * mb],
            st["b_mask"][:, j * nb:(j + 1) * nb])


def kernel_work(cfg, traffic, st, counters, launches) -> dict:
    """Rank 0's own ``bsmm`` work, by ``count``'s rule over its share."""
    if not launches.get("bsmm"):
        return {}
    a, b = rank_share(cfg, st)
    return {"bsmm": (count.blocksparse_flop(a, b, cfg["block"]),
                     count.blocksparse_bytes(a, b, cfg["block"]))}


class GridProgram(UniformProgram):
    """``UniformProgram`` on the grid of the initialised world: the global
    operands in, the whole C out, on every rank."""

    def __init__(self, cfg, traffic, st, device):
        from repro_torch.core.api import DistributedMatmul
        from repro_torch.core.grid import Grid

        self.mm = DistributedMatmul(
            Grid.from_process_group(*cfg["grid"], device=device),
            strategy=traffic["strategy"], k_blocks=traffic.get("k_blocks"),
            local_matmul=traffic["local_matmul"])
        self.n, self.tune = cfg["n"], bool(traffic["tune"])
        self.masks = {"a_mask": st["a_mask"], "b_mask": st["b_mask"]}


def Program(cfg, traffic, st, device):  # noqa: N802 (a route's factory)
    return GridProgram(cfg, traffic, st, device)
