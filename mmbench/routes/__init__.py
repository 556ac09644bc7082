"""Entry routes: how one product enters the program, one module each.

A route module gives, for a configuration ``cfg``, a traffic mix
``traffic`` and the host structure ``st`` it draws from the seed:

* ``structure(cfg, traffic, seed)``: masks, tilings or ranks (``cases``);
* ``operand_a(cfg, traffic, st, seed, device)``: what the program is
  handed as A (B is always the dense ``cases`` operand);
* ``useful_flop(cfg, traffic, st)``: the frozen count of one product;
* ``kernel_work(cfg, traffic, st, counters, launches)``: each hand-written
  kernel's (FLOP, bytes) per product, by the rule of ``count``;
* ``reference_a(cfg, traffic, st, seed, device)`` and
  ``reference_b_rows(b, lo, hi, cfg, traffic, st)``: the reference's A and
  B as worked out again from the inputs, with nothing of the program;
* ``Program(cfg, traffic, st, device)``: the system under test, a callable
  ``(a, b) -> C`` with ``counters()``, the counts the program gives.
"""
from __future__ import annotations


def distributed_matmul(traffic: dict, device):
    """The program's ``DistributedMatmul`` on the one-card grid, as the
    traffic mix configures it."""
    from repro_torch.core.api import DistributedMatmul
    from repro_torch.core.grid import Grid

    return DistributedMatmul(
        Grid.local(device), strategy=traffic["strategy"],
        k_blocks=traffic.get("k_blocks"), local_matmul=traffic["local_matmul"],
    )


class UniformProgram:
    """``DistributedMatmul.__call__`` on square operands, with the traffic
    mix's masks."""

    def __init__(self, n: int, traffic: dict, device, **masks):
        self.mm = distributed_matmul(traffic, device)
        self.n, self.tune, self.masks = n, bool(traffic["tune"]), masks

    def __call__(self, a, b):
        return self.mm(a, b, tune=self.tune, **self.masks)

    def counters(self) -> dict:
        plan = self.mm.plan(self.n, self.n, self.n, tune=self.tune,
                            **self.masks)
        return {"padded": [plan.m_pad, plan.k_pad, plan.n_pad],
                "compact": [self.n] * 3,
                "strategy": plan.cfg.strategy, "local_impl": plan.local_impl,
                "cache": self.mm.cache_stats()}
