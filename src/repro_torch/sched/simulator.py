"""Discrete-event simulation of an explicit matmul task DAG.

The port of ``repro.sched.simulator`` (numpy; the same list scheduling,
so the same makespans, spans and fingerprints as the reference).  Each
device contributes two resources — a compute unit and a comm unit (its
links) — with their own clocks.  Tasks are processed in the
graph's topological order (list-scheduling DES): a task starts at the
max of its dependencies' finish times and its resources' free times, and
runs for a duration the :class:`MachineModel` derives from its FLOP /
byte cost.  Collective tasks (broadcasts, gathers) occupy the comm unit
of *every* group member, so a straggler delays the whole group — the
load-imbalance propagation that the multiple-issue window (encoded as
dependency edges by ``taskgraph``) exists to absorb.  One-sided
``fetch_a``/``fetch_b`` tasks (pull mode, repro.spgemm) list
``(receiver, owner)`` as their devices, so every fetch serializes on the
*owner's* comm clock as well — many requesters of one hot panel queue
there, which is exactly the pull-vs-broadcast crossover the 16 x 16+
virtual-grid experiments measure.

Outputs: makespan, per-device busy/idle split, imbalance ratio,
pipeline-efficiency, and a Chrome-trace (``chrome://tracing`` /
Perfetto) JSON export of the full schedule.

The comm cost model is intentionally the same one ``core.plan.PlanCost``
uses (broadcast-as-allreduce ~2x panel bytes; sparsity-blind bulk
gathers), so simulated and planned bytes agree — the simulator adds the
*time* dimension the static cost model lacks.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.sched.taskgraph import TaskGraph, from_plan

__all__ = [
    "MachineModel",
    "DEFAULT_MACHINE",
    "SimResult",
    "simulate",
    "simulate_plan",
]


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Per-device rates converting abstract task costs to seconds.

    The defaults (1e12 FLOP/s, 5e10 B/s, 1 µs a collective) are the
    reference's, kept so that tuned plans equal the reference's.  They are
    a compute-to-communication ratio for *comparing* schedules, not the
    rates of the H100 or of any other card: a simulated makespan is not a
    prediction of wall time.  A wall-time prediction needs rates measured
    on the card (a timed GEMM, a timed collective) passed in their place.
    """

    flops_per_s: float = 1.0e12
    bytes_per_s: float = 5.0e10
    latency_s: float = 1.0e-6  # per collective launch
    name: str = "default"

    def compute_time(self, flops: float) -> float:
        return flops / self.flops_per_s

    def comm_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return nbytes / self.bytes_per_s + self.latency_s

    def task_time(self, task) -> float:
        if task.resource == "comm":
            return self.comm_time(task.bytes)
        return self.compute_time(task.flops)


DEFAULT_MACHINE = MachineModel()


@dataclasses.dataclass
class SimResult:
    """Outcome of one schedule simulation."""

    makespan_s: float
    busy_compute_s: np.ndarray  # (n_devices,) time the compute unit was busy
    busy_comm_s: np.ndarray  # (n_devices,) time the comm unit was occupied
    graph_meta: dict
    machine: MachineModel
    spans: list | None = None  # (task, start, finish) when traced

    @property
    def n_devices(self) -> int:
        return len(self.busy_compute_s)

    @property
    def idle_s(self) -> np.ndarray:
        """Per-device compute idle time under the makespan."""
        return self.makespan_s - self.busy_compute_s

    @property
    def imbalance_ratio(self) -> float:
        """max/min per-device compute busy time (paper Table 1 style)."""
        busy = self.busy_compute_s
        lo = busy[busy > 0].min() if (busy > 0).any() else 0.0
        return float(busy.max() / lo) if lo > 0 else 1.0

    @property
    def efficiency(self) -> float:
        """Mean compute utilisation: 1.0 = no device ever idle."""
        if self.makespan_s <= 0:
            return 1.0
        return float(self.busy_compute_s.mean() / self.makespan_s)

    def summary(self) -> dict:
        return {
            "makespan_s": self.makespan_s,
            "devices": self.n_devices,
            "busy_compute_mean_s": float(self.busy_compute_s.mean()),
            "busy_compute_max_s": float(self.busy_compute_s.max()),
            "busy_comm_mean_s": float(self.busy_comm_s.mean()),
            "idle_mean_s": float(self.idle_s.mean()),
            "imbalance_ratio": self.imbalance_ratio,
            "efficiency": self.efficiency,
            "machine": self.machine.name,
            **{
                k: self.graph_meta[k]
                for k in ("strategy", "lookahead", "grid", "shape")
                if k in self.graph_meta
            },
        }

    def fingerprint(self) -> str:
        """Stable digest of the simulated schedule: makespan plus every
        recorded span, hashed at full float64 precision.  Two simulations
        of the same graph on the same machine model must be *bitwise*
        identical — the determinism contract the golden-trace test pins
        (the simulator is pure numpy list-scheduling; any nondeterminism
        is a bug)."""
        import hashlib

        h = hashlib.sha1()
        h.update(np.float64(self.makespan_s).tobytes())
        for task, start, finish in self.spans or ():
            h.update(f"{task.tid}:{task.kind}:{task.step}".encode())
            h.update(np.asarray([start, finish], np.float64).tobytes())
        return h.hexdigest()

    # -- Chrome trace --------------------------------------------------------

    def chrome_trace(self) -> dict:
        """``chrome://tracing`` / Perfetto JSON of the simulated schedule.

        One process row per device; compute and comm are separate thread
        rows.  Collective tasks are drawn on every participating device.
        """
        if self.spans is None:
            raise ValueError("simulate(..., trace=True) to record spans")
        events = []
        p_col = self.graph_meta.get("grid", [1, 1])[1]
        for task, start, finish in self.spans:
            tid = 0 if task.resource == "compute" else 1
            for d in task.devices:
                events.append(
                    {
                        "name": f"{task.kind}[{task.step}]",
                        "cat": task.resource,
                        "ph": "X",
                        "ts": start * 1e6,
                        "dur": max((finish - start) * 1e6, 0.01),
                        "pid": int(d),
                        "tid": tid,
                        "args": {
                            "flops": task.flops,
                            "bytes": task.bytes,
                            "device": [d // p_col, d % p_col],
                        },
                    }
                )
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": int(d),
                "args": {"name": f"dev({d // p_col},{d % p_col})"},
            }
            for d in range(self.n_devices)
        ] + [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": int(d),
                "tid": tid,
                "args": {"name": name},
            }
            for d in range(self.n_devices)
            for tid, name in ((0, "compute"), (1, "comm"))
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def simulate(
    graph: TaskGraph,
    machine: MachineModel = DEFAULT_MACHINE,
    *,
    trace: bool = False,
) -> SimResult:
    """Run the DAG through the per-device-clock event simulation."""
    ndev = graph.n_devices
    comp_free = np.zeros(ndev)
    comm_free = np.zeros(ndev)
    busy_comp = np.zeros(ndev)
    busy_comm = np.zeros(ndev)
    finish = np.zeros(len(graph.tasks))
    spans = [] if trace else None
    res_free = {"compute": comp_free, "comm": comm_free}
    res_busy = {"compute": busy_comp, "comm": busy_comm}
    for task, deps in zip(graph.tasks, graph.deps):
        free = res_free[task.resource]
        start = max((finish[d] for d in deps), default=0.0)
        for d in task.devices:
            if free[d] > start:
                start = free[d]
        dur = machine.task_time(task)
        end = start + dur
        finish[task.tid] = end
        busy = res_busy[task.resource]
        for d in task.devices:
            free[d] = end
            busy[d] += dur
        if spans is not None:
            spans.append((task, start, end))
    makespan = float(max(comp_free.max(), comm_free.max())) if ndev else 0.0
    return SimResult(
        makespan_s=makespan,
        busy_compute_s=busy_comp,
        busy_comm_s=busy_comm,
        graph_meta=graph.meta,
        machine=machine,
        spans=spans,
    )


def simulate_plan(
    plan,
    machine: MachineModel = DEFAULT_MACHINE,
    *,
    strategy: str | None = None,
    lookahead: int | None = None,
    trace: bool = False,
) -> SimResult:
    """Materialize a ``MatmulPlan`` and simulate its schedule."""
    graph = from_plan(plan, strategy=strategy, lookahead=lookahead)
    return simulate(graph, machine, trace=trace)
