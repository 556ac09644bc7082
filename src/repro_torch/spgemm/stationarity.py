"""Stationarity choice for sparse x sparse products (DBCSR-style).

DBCSR (arXiv:1910.13555) makes a block-sparse multiplication library
production-grade by *choosing which operand stays put* from modeled
communication volume.  On our 2-D grid the three schedules are:

* **C-stationary** (today's SUMMA layout): A column-panels broadcast
  along grid rows, B row-panels broadcast along grid columns, C never
  moves.
* **A-stationary**: A keeps its (row, col) layout over (M, K); B is
  re-laid-out with K over the grid *columns* and consumed in place; the
  per-device partials ``A_loc @ B_loc`` reduce-scatter along the column
  axis into C's canonical layout.
* **B-stationary**: the mirror — A re-laid-out with K over the grid
  *rows*, partials reduce-scatter along the row axis.

Modeled per-schedule volume: operands that broadcast pay the
broadcast-as-allreduce factor (``taskgraph.BCAST_FACTOR``); the final C
reduction of the A-/B-stationary schedules is a reduce-scatter —
bandwidth-optimal, factor 1.  Volumes are element counts from
``structure.live_elems`` (rank-aware), scaled by itemsize.  Each term is
gated on its axis actually having peers, so 1 x 1 grids tie at zero and
the chooser keeps "C" — bitwise identical to today's plans.
"""
from __future__ import annotations

from repro_torch.sched.taskgraph import BCAST_FACTOR
from repro_torch.spgemm.structure import live_elems, output_mask

__all__ = [
    "STATIONARITIES",
    "stationarity_comm_volumes",
    "choose_stationarity",
]

#: the three schedules, in tie-break priority order ("C" = today's layout)
STATIONARITIES = ("C", "A", "B")


def stationarity_comm_volumes(
    a_structure,
    b_structure,
    *,
    m: int,
    k: int,
    n: int,
    p_row: int,
    p_col: int,
    itemsize: int = 4,
    c_structure=None,
) -> dict[str, float]:
    """Modeled total comm bytes for each stationarity on the structure
    triple.  ``c_structure`` defaults to the symbolic output mask."""
    if c_structure is None:
        c_structure = output_mask(a_structure, b_structure)
    vol_a = live_elems(a_structure, (m, k)) * itemsize
    vol_b = live_elems(b_structure, (k, n)) * itemsize
    vol_c = live_elems(c_structure, (m, n)) * itemsize
    col = 1.0 if p_col > 1 else 0.0  # peers along the column axis
    row = 1.0 if p_row > 1 else 0.0  # peers along the row axis
    return {
        "C": BCAST_FACTOR * (vol_a * col + vol_b * row),
        "A": BCAST_FACTOR * vol_b * row + vol_c * col,
        "B": BCAST_FACTOR * vol_a * col + vol_c * row,
    }


def choose_stationarity(
    a_structure,
    b_structure,
    *,
    m: int,
    k: int,
    n: int,
    p_row: int,
    p_col: int,
    itemsize: int = 4,
    c_structure=None,
) -> tuple[str, dict[str, float]]:
    """The comm-volume argmin over :data:`STATIONARITIES`.

    Ties keep the earlier entry — "C" first — so a chooser that cannot
    distinguish the schedules reproduces today's plans exactly (the
    property the chooser tests pin bitwise).  Returns ``(choice,
    volumes)``; the volumes ride into ``PlanCost.comm_bytes``.
    """
    vols = stationarity_comm_volumes(
        a_structure, b_structure, m=m, k=k, n=n,
        p_row=p_row, p_col=p_col, itemsize=itemsize,
        c_structure=c_structure,
    )
    best = STATIONARITIES[0]
    for s in STATIONARITIES[1:]:
        if vols[s] < vols[best]:
            best = s
    return best, vols
