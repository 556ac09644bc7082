"""Faults planted under the timed path, to see the check catch them.

Each is a ``wrap(program, ctx)`` for ``run.run_cell``: it puts a broken
callable in the program's place, which still runs the program.
"""
from __future__ import annotations


def stale(program, ctx):
    """A product that returns the previous call's C (the state left
    unchanged); the first call returns its own."""
    del ctx
    last = []

    def call(a, b):
        c = program(a, b)
        if not last:
            last.append(c)
        out, last[0] = last[0], c
        return out

    return call


def half_k(program, ctx):
    """Half of the contraction left out and the rest doubled: the product
    with B's second half of rows zeroed, times 2."""
    del ctx

    def call(a, b):
        b_half = b.clone()
        b_half[b.shape[0] // 2:] = 0
        return program(a, b_half) * 2

    return call


def altered(program, ctx):
    """One block of C zeroed where it is produced, another each product."""
    block = ctx["cfg"].get("block") or ctx["cfg"]["avg_block"]
    count = [0]

    def call(a, b):
        c = program(a, b)
        nb = c.shape[0] // block
        i, j = count[0] % nb, (count[0] * 7 + 3) % nb
        count[0] += 1
        c[i * block:(i + 1) * block, j * block:(j + 1) * block] = 0
        return c

    return call


FAULTS = {"stale": stale, "half_k": half_k, "altered": altered}
