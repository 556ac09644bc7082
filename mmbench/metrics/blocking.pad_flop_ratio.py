"""The padded product's FLOP, at the extents of the program's plan, over
the compact product's."""


def read(view):
    padded, compact = view.counters.get("padded"), view.counters.get("compact")
    if not padded or not compact:
        return None
    return (padded[0] * padded[1] * padded[2]) / (
        compact[0] * compact[1] * compact[2])
