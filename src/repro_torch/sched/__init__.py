"""repro_torch.sched: explicit task graphs, schedule simulation, tuning.

The port of ``repro.sched`` (numpy over ``MatmulPlan``; no device work).
The paper's contribution is a *scheduler* — fine-grained tasks with real
dependency edges, multiple-issue lookahead (Eq. 1), imbalance absorbed
by overlap.  ``core.summa`` executes that schedule; this package reasons
about it:

* ``taskgraph``  — materialize a ``MatmulPlan`` (or nonuniform tilings)
  into broadcast/gemm/accumulate tasks with FLOP/byte costs.
* ``simulator``  — discrete-event simulation: per-device clocks, comm
  model shared with ``plan.PlanCost``, makespan / busy / imbalance /
  Chrome-trace outputs; scales to thousands of virtual devices.
* ``tuner``      — search lookahead x k_blocks x strategy over the
  simulator; feeds the winner back into ``DistributedMatmul.plan(
  tune=True)`` and ``matmul_strategy="auto"``.

CLI: ``python -m repro_torch.sched --grid 4 4 --extent 2048 --nonuniform``.
"""
from repro_torch.sched.simulator import (
    DEFAULT_MACHINE,
    MachineModel,
    SimResult,
    simulate,
    simulate_plan,
)
from repro_torch.sched.taskgraph import (
    BCAST_FACTOR,
    Task,
    TaskGraph,
    abstract_summa_config,
    chain_graphs,
    eq1_lookahead,
    from_plan,
    from_tilings,
)
from repro_torch.sched.tuner import (
    lookahead_candidates,
    ring_makespan,
    tune_chain,
    tune_plan,
)

__all__ = [
    "BCAST_FACTOR",
    "DEFAULT_MACHINE",
    "MachineModel",
    "SimResult",
    "simulate",
    "simulate_plan",
    "Task",
    "TaskGraph",
    "abstract_summa_config",
    "chain_graphs",
    "eq1_lookahead",
    "from_plan",
    "from_tilings",
    "lookahead_candidates",
    "ring_makespan",
    "tune_chain",
    "tune_plan",
]
