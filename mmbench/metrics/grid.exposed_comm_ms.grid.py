"""Device milliseconds per product in which an NCCL kernel of the
program's calls runs on rank 0's card and nothing else does (no other
kernel, copy or fill), over the traced products: the communication that
no computation hides.  A change that overlaps the broadcasts with
``bsmm`` lowers it."""
from mmbench.trace import Trace


def read(view):
    if view.trace is None or not view.trace.calls:
        return None
    nccl = [i for i in view.trace.intervals if i.program and "nccl" in i.name]
    if not nccl:
        return None
    others = [i for i in view.trace.intervals if "nccl" not in i.name]

    def union_us(intervals):
        return Trace(intervals, [], [], 0, None).busy_us(*view.trace.window)

    return (union_us(nccl + others) - union_us(others)) / 1e3 / len(
        view.trace.calls)
