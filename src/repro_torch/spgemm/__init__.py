"""repro_torch.spgemm — output-structure-aware sparse x sparse planning.

The port's copy of ``repro.spgemm``'s two numpy modules, which the
planner (``core.plan``) consults on every plan:

* ``structure`` — the symbolic output-structure pass (``c = a (.) b``
  boolean block products, rank-aware), norm screening and the modeled
  element volume of a travelling operand;
* ``stationarity`` — the DBCSR-style A-/B-/C-stationary chooser from
  modeled comm volume.  Only C-stationary plans execute in this package
  so far; ``core.summa.execute_plan`` raises for the others.
"""
from repro_torch.spgemm.stationarity import (
    STATIONARITIES,
    choose_stationarity,
    stationarity_comm_volumes,
)
from repro_torch.spgemm.structure import (
    as_block_mask,
    as_rank_grid,
    filter_keep,
    live_elems,
    output_mask,
    output_norms,
    output_rank_bound,
)

__all__ = [
    "STATIONARITIES",
    "choose_stationarity",
    "stationarity_comm_volumes",
    "as_block_mask",
    "as_rank_grid",
    "filter_keep",
    "live_elems",
    "output_mask",
    "output_norms",
    "output_rank_bound",
]
