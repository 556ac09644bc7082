"""A as the factors U·V of blocks of decaying rank (the program's
``RankCSR``), B dense, through ``DistributedMatmul(None, b, a_ranks=...)``:
the factor route, stage 1 (each block's V @ B panel) on ``grouped_gemm``,
stage 2 (U applied per block row) as a batched product."""
from __future__ import annotations

import numpy as np
import torch

from mmbench import cases, count
from mmbench.routes import distributed_matmul
from mmbench.routes.dense import reference_b_rows  # noqa: F401 (a hook)


def structure(cfg, traffic, seed) -> dict:
    nb = cfg["n"] // cfg["block"]
    return {"ranks": cases.decay_ranks(nb, nb, traffic["max_rank"],
                                       traffic["decay"], traffic["threshold"])}


def operand_a(cfg, traffic, st, seed, device):
    """The program's ``RankCSR`` of the factors drawn on the card, as a
    caller hands it: its factors on the host."""
    from repro_torch.core.sparsity import RankCSR, block_csr_from_mask

    ranks, block = st["ranks"], cfg["block"]
    u, v = cases.rank_factors(ranks, block, seed, device)
    return RankCSR(csr=block_csr_from_mask(ranks > 0),
                   ranks=ranks[ranks > 0].astype(np.int32),
                   u=u.cpu().numpy(), v=v.cpu().numpy(), bm=block, bk=block)


def useful_flop(cfg, traffic, st) -> float:
    return count.rank_flop(st["ranks"], cfg["block"], cfg["block"], cfg["n"])


def kernel_work(cfg, traffic, st, counters, launches) -> dict:
    """Stage 1 at the true ranks: each live block's V (r × bk) times its
    panel of B, V and B read once, the (r × n) products written once."""
    if not launches.get("grouped_gemm"):
        return {}
    n, bk = cfg["n"], cfg["block"]
    r = float(st["ranks"].sum())
    return {"grouped_gemm": (2.0 * r * bk * n,
                             (r * bk + n * n + r * n) * count.FP32)}


def reference_a(cfg, traffic, st, seed, device):
    """A, dense, from the factors drawn again: each live block U @ V in
    float64, placed at its block."""
    ranks, block, n = st["ranks"], cfg["block"], cfg["n"]
    u, v = cases.rank_factors(ranks, block, seed, device)
    blocks = torch.bmm(u.double(), v.double())
    del u, v
    nb = n // block
    a = torch.zeros((nb, nb, block, block), dtype=torch.float64, device=device)
    live = torch.as_tensor(np.argwhere(ranks > 0), device=device)
    a[live[:, 0], live[:, 1]] = blocks
    return a.permute(0, 2, 1, 3).reshape(n, n)


class Program:
    def __init__(self, cfg, traffic, st, device):
        self.mm = distributed_matmul(traffic, device)
        self.n, self.tune = cfg["n"], bool(traffic["tune"])
        self.a_ranks = None  # the operand of the last call

    def __call__(self, a, b):
        self.a_ranks = a
        return self.mm(None, b, a_ranks=a, tune=self.tune)

    def counters(self) -> dict:
        n = self.n
        if self.a_ranks is None:
            return {"compact": [n] * 3}
        plan = self.mm.plan(n, n, n, a_ranks=self.a_ranks, tune=self.tune)
        return {"padded": [plan.m_pad, plan.k_pad, plan.n_pad],
                "compact": [n] * 3, "strategy": plan.cfg.strategy,
                "local_impl": plan.local_impl, "cache": self.mm.cache_stats()}
