"""Schedule autotuner: search lookahead x k_blocks x strategy by simulation.

The port of ``repro.sched.tuner``: the same candidates in the same order,
so a tuned plan's fields and its ``tuned`` record equal the reference's.

``core.plan.PlanCost`` ranks strategies by modeled *bytes* — a static
tie-break that knows nothing about overlap, pipelining, or imbalance.
The tuner replaces it: every candidate schedule is materialized as an
explicit task DAG (``taskgraph``) and run through the discrete-event
simulator; the winner is the schedule with the smallest simulated
makespan.  Because the static cost-model choice is always one of the
candidates, the tuned schedule is **never worse** (in simulated
makespan) than the static pick.

Entry points:

* :func:`tune_plan` — returns a new ``MatmulPlan`` whose config carries
  the winning strategy / ``k_blocks`` and whose ``lookahead`` field holds
  the winning window (``core.summa._exec_taskbased`` honors it).  The
  search record is attached as ``plan.tuned``.
* :func:`ring_makespan` — closed-form pipeline estimate for the ring
  collective matmul (``dist.collective_matmul.allgather_matmul``), so
  ``project(strategy="auto")`` can route between the ring and the tuned
  SUMMA schedule on simulated time instead of bytes.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis.spans import spanned
from repro_torch.sched.simulator import (
    DEFAULT_MACHINE,
    MachineModel,
    simulate,
)
from repro_torch.sched.taskgraph import eq1_lookahead, from_plan

__all__ = [
    "tune_plan",
    "tune_chain",
    "ring_makespan",
    "lookahead_candidates",
]

#: strategies the tuner may select for plan execution
TUNABLE_STRATEGIES = ("procedural", "taskbased", "allgather")


def lookahead_candidates(p_row: int, p_col: int, k_steps: int) -> list[int]:
    """Candidate multiple-issue windows: serial, minimal overlap, Eq. (1)
    and its half, and the fully-unrolled I = K endpoint."""
    eq1 = eq1_lookahead(p_row, p_col, k_steps)
    cap = max(k_steps, 1)
    cands = {1, 2, max(1, eq1 // 2), eq1, cap}
    return sorted(c for c in cands if 1 <= c <= cap)


def _k_block_candidates(cfg, k_steps: int) -> list[int | None]:
    """``k_blocks`` (over-decomposition) candidates: the plan's own value
    plus the classic grid counts and 2x / 4x over-decompositions."""
    lcm = math.lcm(cfg.p_row, cfg.p_col)
    cands: list[int | None] = [cfg.k_blocks]
    for kb in (max(cfg.p_row, cfg.p_col), lcm, 2 * lcm, 4 * lcm):
        if kb not in cands:
            cands.append(kb)
    return cands


def _sim_summary(sim) -> dict:
    return {
        "makespan_s": sim.makespan_s,
        "imbalance_ratio": sim.imbalance_ratio,
        "efficiency": sim.efficiency,
    }


@spanned("plan.tune")
def tune_plan(
    plan,
    *,
    machine: MachineModel = DEFAULT_MACHINE,
    strategies: tuple[str, ...] = TUNABLE_STRATEGIES,
):
    """Return a tuned copy of ``plan`` (same logical product, best
    simulated schedule).

    Dense plans search strategy x k_blocks x lookahead (re-planning per
    ``k_blocks`` so padding effects are priced in).  Masked plans always
    execute the planned broadcast schedule, so only the window is tuned.
    The returned plan's ``tuned`` dict records the winner and the static
    cost-model baseline; callers must re-pad operands to the tuned plan's
    ``padded_shapes`` (``core.api.DistributedMatmul`` does).
    """
    from repro_torch.core.plan import plan_matmul

    base_cfg = plan.cfg
    if plan.local_impl == "dense":
        static_strategy = plan.cost.best_strategy(("taskbased", "allgather"))
    else:
        # masked plans always execute the planned broadcast schedule; the
        # static baseline is that schedule at the Eq.-(1) window.
        static_strategy = "taskbased"
    static_sim = simulate(from_plan(plan, strategy=static_strategy), machine)

    best = None  # (makespan, order, plan_variant, lookahead, sim)
    n_cands = 0

    def consider(cand_plan, strategy, lookahead):
        nonlocal best, n_cands
        graph = from_plan(cand_plan, strategy=strategy, lookahead=lookahead)
        sim = simulate(graph, machine)
        n_cands += 1
        key = (sim.makespan_s, n_cands)
        if best is None or key < (best[0], best[1]):
            best = (sim.makespan_s, n_cands, cand_plan, strategy,
                    graph.lookahead, sim)

    if plan.local_impl != "dense":
        # Masked (dense-stored) plans may also flip the comm mode: the
        # one-sided pull schedule wins when fill is low enough that
        # per-gemm fetches beat panel broadcasts (repro.spgemm), and the
        # fetch graph's owner-clock contention is exactly what the
        # simulator prices.  Rank-sparse plans pull factor panels
        # (``summa._exec_ranksparse_pull``); bsmm plans keep their
        # broadcast pipeline (their executor is broadcast-only).
        # Masked plans additionally search the stationarity axis: the
        # A-/B-stationary schedules execute the same product through
        # summa's transposed executors, so the tuner may pick them on
        # *simulated* makespan rather than the chooser's modeled bytes.
        base_st = getattr(plan, "stationarity", "C")
        stats = [base_st]
        if plan.local_impl == "masked" and base_st == "C":
            stats = ["C", "A", "B"]
        for st in stats:
            st_plan = (
                plan if st == base_st
                else dataclasses.replace(plan, stationarity=st)
            )
            if st != "C":
                # stationary schedules have no K pipeline — one candidate,
                # no multiple-issue window to sweep
                consider(st_plan, "taskbased", 1)
                continue
            modes = ["broadcast"]
            if (
                plan.local_impl == "masked" and plan.a_ranks is None
            ) or plan.local_impl == "ranksparse":
                modes = ["broadcast", "pull"]
            for mode in modes:
                if mode == getattr(st_plan, "comm_mode", "broadcast"):
                    cand = st_plan
                else:
                    cand = dataclasses.replace(st_plan, comm_mode=mode)
                for la in lookahead_candidates(plan.p_row, plan.p_col,
                                               len(plan.live_panels)):
                    consider(cand, "taskbased", la)
    else:
        for kb in _k_block_candidates(base_cfg, plan.k_steps):
            if kb == base_cfg.k_blocks:
                variant = plan
            else:
                try:
                    variant = plan_matmul(
                        plan.m, plan.k, plan.n,
                        dataclasses.replace(base_cfg, k_blocks=kb),
                        itemsize=plan.itemsize,
                    )
                except ValueError:
                    continue  # k_blocks incompatible with this K / grid
            las = lookahead_candidates(
                variant.p_row, variant.p_col, variant.k_steps
            )
            for strategy in strategies:
                if strategy == "procedural":
                    consider(variant, strategy, 1)
                elif strategy == "allgather":
                    consider(variant, strategy, None)
                else:
                    for la in las:
                        consider(variant, strategy, la)

    _, _, win_plan, win_strategy, win_la, win_sim = best
    tuned_cfg = dataclasses.replace(win_plan.cfg, strategy=win_strategy)
    info = {
        "strategy": win_strategy,
        "k_blocks": win_plan.k_steps,
        "lookahead": int(win_la),
        "stationarity": getattr(win_plan, "stationarity", "C"),
        "comm_mode": getattr(win_plan, "comm_mode", "broadcast"),
        **_sim_summary(win_sim),
        "static_strategy": static_strategy,
        "static_makespan_s": static_sim.makespan_s,
        "speedup_vs_static": (
            static_sim.makespan_s / win_sim.makespan_s
            if win_sim.makespan_s > 0 else 1.0
        ),
        "n_candidates": n_cands,
        "machine": machine.name,
    }
    return dataclasses.replace(
        win_plan, cfg=tuned_cfg, lookahead=int(win_la), tuned=info
    )


def tune_chain(
    builders,
    *,
    machine: MachineModel = DEFAULT_MACHINE,
    max_evals: int = 256,
    default_graphs=None,
):
    """Pick the per-step multiple-issue windows of a chained
    multiplication *jointly* by simulated makespan of the union graph.

    ``builders`` is one callable per chain step, ``lookahead ->
    TaskGraph`` (``None`` = the step's Eq.-(1) default); the union is
    assembled by ``taskgraph.chain_graphs``, so cross-step overlap is
    part of what the search sees — a window that is optimal for a step
    in isolation can lose to one that drains its tail earlier and
    unblocks the next step's A-panel broadcasts.

    The full candidate product is searched when it fits in
    ``max_evals`` simulations; beyond that each step keeps its
    isolated-best window (greedy fallback).  The default (Eq.-1) windows
    are always a candidate, so the tuned chain is never worse than the
    untuned one in simulated makespan.

    ``default_graphs`` accepts the per-step default (Eq.-1) graphs if the
    caller already built them, avoiding a duplicate materialization.
    Returns ``(lookaheads, sim, record)``.
    """
    import itertools

    from repro_torch.sched.taskgraph import chain_graphs

    defaults = (
        default_graphs if default_graphs is not None
        else [b(None) for b in builders]
    )
    default_las = [g.lookahead for g in defaults]
    cand_lists = [
        lookahead_candidates(g.p_row, g.p_col, g.n_steps) for g in defaults
    ]
    for las, g in zip(cand_lists, defaults):
        if g.lookahead not in las:
            las.append(g.lookahead)
    total = math.prod(len(c) for c in cand_lists)
    if total <= max_evals:
        combos = itertools.product(*cand_lists)
    else:
        # greedy fallback: each step keeps its isolated-best window, and
        # the all-defaults combo rides along — two chain evaluations
        # regardless of chain length (the per-step probe sims are linear
        # in the number of steps, never a product).
        bests = []
        for b, g in zip(builders, defaults):
            las = lookahead_candidates(g.p_row, g.p_col, g.n_steps)
            bests.append(min(
                las, key=lambda la: simulate(b(la), machine).makespan_s
            ))
        combos = [tuple(default_las), tuple(bests)]
    best = None  # (makespan, order, las, sim)
    n_evals = 0
    default_key = tuple(default_las)
    default_sim = None
    for las in combos:
        graph = chain_graphs([b(la) for b, la in zip(builders, las)])
        sim = simulate(graph, machine)
        n_evals += 1
        if tuple(las) == default_key:
            default_sim = sim  # the default combo is always a candidate
        key = (sim.makespan_s, n_evals)
        if best is None or key < (best[0], best[1]):
            best = (sim.makespan_s, n_evals, las, sim)
    _, _, win_las, win_sim = best
    if default_sim is None:  # defensive: candidates lists were customized
        default_sim = simulate(chain_graphs(defaults), machine)
    record = {
        "lookaheads": [int(la) for la in win_las],
        "default_lookaheads": [int(la) for la in default_las],
        **_sim_summary(win_sim),
        "default_makespan_s": default_sim.makespan_s,
        "speedup_vs_default": (
            default_sim.makespan_s / win_sim.makespan_s
            if win_sim.makespan_s > 0 else 1.0
        ),
        "n_candidates": n_evals,
        "machine": machine.name,
    }
    return list(win_las), win_sim, record


def ring_makespan(
    plan,
    machine: MachineModel = DEFAULT_MACHINE,
    *,
    lookahead: int = 2,
) -> float:
    """Pipeline estimate for the ring collective matmul over ``p_col``.

    Each of the ``p`` activation chunks takes one hop per step while the
    chunk in hand multiplies against the local weight columns; with
    ``lookahead`` hops in flight the steady state is bound by the slower
    of the two streams (cf. ``allgather_matmul``'s prefetch pipeline).
    """
    p = plan.p_col
    m_loc = plan.m_pad // plan.p_row
    n_loc = plan.n_pad // plan.p_col
    gemm = machine.compute_time(2.0 * (m_loc / p) * plan.k_pad * n_loc)
    if p <= 1:
        return gemm
    hop = machine.comm_time((m_loc / p) * plan.k_pad * plan.itemsize)
    fill = hop * max(1, min(lookahead, p) - 1)
    return fill + max((p - 1) * hop, (p - 1) * gemm) + gemm
