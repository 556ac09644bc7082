"""Block-sparse A and B (independent random block masks) through
``DistributedMatmul``: on one card the masked operands go to one ``bsmm``
launch over A's live blocks."""
from __future__ import annotations

from mmbench import cases, count, reference
from mmbench.routes import UniformProgram
from mmbench.routes.dense import operand_a  # noqa: F401 (a route's hook)


def structure(cfg, traffic, seed) -> dict:
    """One pair of masks at the traffic's ``mask_seed``, the same for every
    run, in the same order: the seed draws the values, the bands and the
    checked rows, not the structure.  (Permuting the blocks by the seed kept
    the live triples but moved ``bsmm``'s pace by ~1 % from seed to seed.)"""
    nb = cfg["n"] // cfg["block"]
    a = cases.random_block_mask(nb, nb, traffic["a_fill"],
                                cases.host_rng(traffic["mask_seed"], cases.A_MASK))
    b = cases.random_block_mask(nb, nb, traffic["b_fill"],
                                cases.host_rng(traffic["mask_seed"], cases.B_MASK))
    return {"a_mask": a, "b_mask": b}


def useful_flop(cfg, traffic, st) -> float:
    return count.blocksparse_flop(st["a_mask"], st["b_mask"], cfg["block"])


def kernel_work(cfg, traffic, st, counters, launches) -> dict:
    if not launches.get("bsmm"):
        return {}
    return {"bsmm": (
        useful_flop(cfg, traffic, st),
        count.blocksparse_bytes(st["a_mask"], st["b_mask"], cfg["block"]),
    )}


def reference_a(cfg, traffic, st, seed, device):
    a = operand_a(cfg, traffic, st, seed, device)
    reference.mask_rows_(a, st["a_mask"], cfg["block"], 0, cfg["n"])
    return a


def reference_b_rows(b, lo, hi, cfg, traffic, st) -> None:
    reference.mask_rows_(b, st["b_mask"], cfg["block"], lo, hi)


def Program(cfg, traffic, st, device):  # noqa: N802 (a route's factory)
    return UniformProgram(cfg["n"], traffic, device,
                          a_mask=st["a_mask"], b_mask=st["b_mask"])
