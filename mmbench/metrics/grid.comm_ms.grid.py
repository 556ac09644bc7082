"""Device milliseconds per product in which an NCCL kernel of the
program's calls runs on rank 0's card (the union of those kernels'
intervals in the profiler's trace, by kernel name, over the traced
products): the broadcasts of the live panels and the gathers of C, with
the time they wait for peers."""
from mmbench.trace import Trace


def read(view):
    if view.trace is None or not view.trace.calls:
        return None
    nccl = [i for i in view.trace.intervals if i.program and "nccl" in i.name]
    if not nccl:
        return None
    union = Trace(nccl, [], [], 0, None).busy_us(*view.trace.window)
    return union / 1e3 / len(view.trace.calls)
