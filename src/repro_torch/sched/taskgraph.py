"""Task-graph constants shared with the planner's comm model.

The explicit task DAG, its simulator and the schedule tuner of
``repro.sched`` are not ported yet; ``spgemm.stationarity`` needs only
the broadcast factor below.
"""
from __future__ import annotations

__all__ = ["BCAST_FACTOR"]

#: broadcast-as-allreduce moves ~2x the panel bytes of a tree broadcast
#: (same factor as ``core.plan._comm_model``).
BCAST_FACTOR = 2.0
