#!/usr/bin/env python3
"""Where the time of one rank-sparse product goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/profile_rank_route.py

It builds ``configs/paper_mm.make_rank_factors(32768, 256, 64)`` (the
rank-sparse case of ``chip_smoke.py``) and a standard-normal B drawn on
the card.  For each local route (``pallas``, the grouped kernel, then
``xla``) it runs ``DistributedMatmul(None, b, a_ranks=rcsr)`` once to warm
up, then traces one more product with ``torch.profiler`` and prints the
wall time (host clock ending in ``synchronize``), the device time summed
by kernel name (largest first) and the device's busy share of the wall.
The factor layout (``rank_operands``) is memoized on the ``RankCSR``, so
the traced calls hold the copy of the factors to the card but not their
layout on the host.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import DistributedMatmul, Grid  # noqa: E402
from repro_torch.configs.paper_mm import make_rank_factors  # noqa: E402


N, BLOCK, MAX_RANK = 32768, 256, 64


def profile_route(route: str, rcsr, b) -> None:
    mm = DistributedMatmul(Grid.local("cuda"), strategy="taskbased",
                           k_blocks=N // BLOCK, local_matmul=route)
    mm(None, b, a_ranks=rcsr)  # warm-up: build, plan, factor layout
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mm(None, b, a_ranks=rcsr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"route={route} N={N}: wall {wall * 1e3:.3f} ms (traced), "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e3 / (wall * 1e3):.3f} of the wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_rank_route: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    rcsr = make_rank_factors(N, BLOCK, MAX_RANK, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.randn((N, N), generator=gen, device="cuda")
    for route in ("pallas", "xla"):
        profile_route(route, rcsr, b)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
