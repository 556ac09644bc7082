"""Dense square operands through ``DistributedMatmul``: on one card the
task-based SUMMA loop, one ``tiled_matmul`` per K panel added into C."""
from __future__ import annotations

from mmbench import cases, count
from mmbench.routes import UniformProgram


def structure(cfg, traffic, seed) -> dict:
    del cfg, traffic, seed
    return {}


def operand_a(cfg, traffic, st, seed, device):
    return cases.operand(cfg["n"], seed, cases.A_VALUES, device)


def useful_flop(cfg, traffic, st) -> float:
    return count.dense_flop(cfg["n"], cfg["n"], cfg["n"])


def kernel_work(cfg, traffic, st, counters, launches) -> dict:
    m, k, n = counters["padded"]
    if not launches.get("tiled_matmul"):
        return {}
    return {"tiled_matmul": (count.dense_flop(m, k, n),
                             count.tiled_bytes(m, k, n, launches["tiled_matmul"]))}


def reference_a(cfg, traffic, st, seed, device):
    return operand_a(cfg, traffic, st, seed, device)


def reference_b_rows(b, lo, hi, cfg, traffic, st) -> None:
    del b, lo, hi, cfg, traffic, st


def Program(cfg, traffic, st, device):  # noqa: N802 (a route's factory)
    return UniformProgram(cfg["n"], traffic, device)
