"""repro_torch.sched — the task-graph scheduler's constants the planner needs.

Only ``taskgraph.BCAST_FACTOR`` is ported so far; the task graph, the
simulator and the tuner are queued (ROADMAP, queue A).
"""
