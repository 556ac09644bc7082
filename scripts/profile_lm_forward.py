#!/usr/bin/env python3
"""Where the time of one LM forward goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/profile_lm_forward.py            # llama3.2-1b
    python3 scripts/profile_lm_forward.py --arch mixtral-8x7b --layers 8

It builds the architecture (default llama3.2-1b) at full width
(``init_model``, seed 0, bf16; the models of ``chip_smoke.py`` phase 8
and [moe]), its depth cut to ``--layers`` when given, and ``--batch``
prompts of ``--seq`` tokens (default 4 x 4096), runs
``models.model.forward(..., use_kernel=True)`` twice to warm up, then
traces one more forward with ``torch.profiler`` and prints the wall time
(host clock ending in ``synchronize``), the device time summed by kernel
name (largest first), the device's busy share of the wall, and the
device time grouped into attention (the ``flash_attention`` kernel), the
expert GEMMs of a MoE model (the ``grouped_gemm`` kernel), matrix
products (cuBLAS GEMM kernels) and the rest.  It exits non-zero if the
profiler records no device time on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.dist.context import ParallelCtx  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.grouped_gemm import grouped_gemm_cuda  # noqa: E402
from repro_torch.models.model import forward, init_model  # noqa: E402

def group(name: str) -> str:
    """The part of the forward a device kernel belongs to."""
    low = name.lower()
    if "fa_wgmma_kernel" in low or "fa_fma_kernel" in low:
        return "attention (flash_attention)"
    if "grouped_gemm_kernel" in low:
        return "expert GEMMs (grouped_gemm)"
    if any(k in low for k in ("nvjet", "gemm", "sm90_xmma", "cutlass",
                              "cublas")):
        return "matrix products (cuBLAS)"
    return "elementwise, norms, softmax of the logits, copies"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="llama3.2-1b")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seq", type=int, default=4096)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_lm_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = init_model(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(6))
    ctx = ParallelCtx(None)
    with torch.inference_mode():
        for _ in range(2):  # warm-up: build, cuBLAS heuristics, allocator
            forward(model, {"tokens": tokens}, cfg, ctx, use_kernel=True)
    torch.cuda.synchronize()
    flash_attention_cuda.launches = grouped_gemm_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            forward(model, {"tokens": tokens}, cfg, ctx, use_kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"{cfg.name} ({cfg.num_layers} layers) forward B={args.batch} "
          f"S={args.seq} bf16 through the kernels: wall {wall * 1e3:.3f} ms "
          f"(traced), flash_attention launches "
          f"{flash_attention_cuda.launches}, grouped_gemm launches "
          f"{grouped_gemm_cuda.launches}")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        sys.exit("profile_lm_forward: torch.profiler recorded no device "
                 "time on this card")
    print(f"device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e3 / (wall * 1e3):.3f} of the wall)")
    groups: dict[str, float] = {}
    for e in events:
        groups[group(e.key)] = groups.get(group(e.key), 0.0) + (
            e.self_device_time_total)
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:10.3f} ms  {us / busy_us:.3f} of device time  "
              f"{name}")
    print("by kernel:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
