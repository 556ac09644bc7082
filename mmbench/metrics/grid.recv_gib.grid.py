"""GiB per product that rank 0's collectives deliver to it: the program's
counter ``grid.recv_bytes`` over the traced products, each collective's
result on the rank (the broadcast panels, its own among them, and the
gathered C)."""
from mmbench import spans


def read(view):
    if view.trace is None or not view.trace.calls:
        return None
    s = spans.summary()
    traced = len(view.trace.calls)
    if s is None or s["spans"].get("api.call", {}).get("count") != traced \
            or not s["counters"].get("grid.recv_bytes"):
        return None
    return s["counters"]["grid.recv_bytes"] / traced / 2**30
