"""Dense operands over nonuniform logical blocks through
``NonuniformMatmul``: the blocks are bucketed into uniform physical tiles,
the operands gathered into the padded layout, multiplied by the wrapped
``DistributedMatmul`` and C gathered back to the compact layout."""
from __future__ import annotations

from mmbench import cases, count
from mmbench.routes import distributed_matmul
from mmbench.routes.dense import (  # noqa: F401 (a route's hooks)
    kernel_work,
    operand_a,
    reference_a,
    reference_b_rows,
    useful_flop,
)


def structure(cfg, traffic, seed) -> dict:
    return {"sizes": cases.nonuniform_sizes(
        cfg["n"], cfg["num_blocks"], cfg["sizes_seed"], seed)}


class Program:
    def __init__(self, cfg, traffic, st, device):
        from repro_torch.core.api import NonuniformMatmul
        from repro_torch.core.blocking import Tiling

        self.n, self.tune = cfg["n"], bool(traffic["tune"])
        self.nm = NonuniformMatmul(
            distributed_matmul(traffic, device),
            *(Tiling(tuple(s)) for s in st["sizes"]), tile=traffic["tile"],
        )

    def __call__(self, a, b):
        return self.nm(a, b, tune=self.tune)

    def counters(self) -> dict:
        plan = self.nm.plan(tune=self.tune)
        return {"padded": [plan.m_pad, plan.k_pad, plan.n_pad],
                "compact": [self.n] * 3,
                "strategy": plan.cfg.strategy, "local_impl": plan.local_impl,
                "cache": self.nm.mm.cache_stats()}
