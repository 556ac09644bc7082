#!/usr/bin/env python3
"""Where the time of one train step goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card::

    python3 scripts/profile_train_step.py          # llama3.2-1b, 8 x 4096
    python3 scripts/profile_train_step.py --layers 2 --batch 4

It builds the train state of the architecture (default llama3.2-1b) at
full width (``train.train_step.make_train_state``, seed 0, bf16, AdamW;
the state of ``chip_smoke.py`` [train]), its depth cut to ``--layers``
when given, and ``build_train_step`` with ``--microbatches`` (default 2)
over ``SyntheticData`` batches of ``--batch`` x ``--seq`` tokens (default
8 x 4096), ``attention_impl="chunked"`` and remat.  It runs two steps to
warm up, then traces one more with ``torch.profiler`` and prints the
wall (host clock ending in ``synchronize``), tokens/s, peak memory, the
device's busy share, the device time of the chunked attention's forward
(its recomputation under remat included) and backward, of the optimizer
update, of ``matmul_f32``'s backward with an fp32 cotangent (the tied
head's, its bf16 operand widened) and with a bf16 one (the projections')
(each the span on the stream between CUDA events around its calls), the
device time of matrix products (cuBLAS kernels), then the
device time by kernel name.  The chunked
attention's parts are also timed alone with CUDA events at the step's
call (one microbatch's B, the model's heads), times the calls a step
makes.  It exits non-zero if the profiler records no device time.
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
from torch.profiler import (  # noqa: E402
    ProfilerActivity,
    profile,
    record_function,
)

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import Grid  # noqa: E402
from repro_torch.dist.context import ParallelCtx  # noqa: E402
from repro_torch.models import chunked_attention as ca  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.train.data import SyntheticData  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    Optimizer,
    OptimizerConfig,
    make_optimizer,
)
from repro_torch.train.train_step import (  # noqa: E402
    build_train_step,
    make_train_state,
)

DEVICE = "cuda"
RANGES = ("chunked_attention.fwd", "chunked_attention.bwd",
          "optimizer.update", "matmul_f32.bwd, fp32 cotangent",
          "matmul_f32.bwd, bf16 cotangent")


#: (start, end) CUDA events of each call of a ranged function
SPANS: dict[str, list] = {name: [] for name in RANGES}


def ranged(name: str, fn):
    """``fn`` inside a profiler range, its span on the stream recorded."""
    def run(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with record_function(name):
            out = fn(*args, **kw)
        end.record()
        SPANS[name].append((start, end))
        return out
    return run


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in ("nvjet", "gemm", "sm90_xmma", "cutlass",
                                  "cublas"))


def event_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_alone(cfg, b: int, s: int) -> tuple[float, float]:
    """(forward ms, forward + backward ms) of ``chunked_attention`` at the
    step's call in the model's dtype, from CUDA events."""
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE)
                   .to(dtype) for shape in ((b, h, s, dh), (b, hkv, s, dh),
                                            (b, hkv, s, dh), (b, h, s, dh)))

    def both():
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        ca.chunked_attention(qs, ks, vs).backward(do)

    with torch.no_grad():
        fwd = event_ms(lambda: ca.chunked_attention(q, k, v))
    return fwd, event_ms(both)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="llama3.2-1b")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=4096)
    parser.add_argument("--microbatches", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    ctx = ParallelCtx(Grid.local(DEVICE), attention_impl="chunked")
    opt = make_optimizer(OptimizerConfig(total_steps=10, warmup_steps=1))
    opt = Optimizer(init=opt.init,
                    update=ranged("optimizer.update", opt.update))
    ca._fwd = ranged("chunked_attention.fwd", ca._fwd)
    ca._bwd = ranged("chunked_attention.bwd", ca._bwd)
    mm_bwd = {dtype: ranged(f"matmul_f32.bwd, {name} cotangent",
                            layers._MatmulF32.backward)
              for dtype, name in ((torch.float32, "fp32"),
                                  (torch.bfloat16, "bf16"))}
    layers._MatmulF32.backward = staticmethod(
        lambda fctx, g: mm_bwd[g.dtype](fctx, g))
    state = make_train_state(cfg, ctx, opt, device=DEVICE,
                             generator=torch.Generator(
                                 device=DEVICE).manual_seed(0))
    step = build_train_step(cfg, ctx, opt, microbatches=args.microbatches)
    data = SyntheticData(cfg, args.batch, args.seq, seed=0)
    for i in range(2):  # warm-up: cuBLAS heuristics, allocator
        state, _ = step(state, data.batch_at(i))
    batch = data.batch_at(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for spans in SPANS.values():
        spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    tokens = args.batch * args.seq
    print(f"{cfg.name} ({cfg.num_layers} layers) train step, {args.batch} x "
          f"{args.seq} tokens in {args.microbatches} microbatches, "
          f"{cfg.dtype}, AdamW, chunked attention, remat: wall "
          f"{wall * 1e3:.3f} ms (traced), {tokens / wall:,.0f} tokens/s, "
          f"loss {float(metrics['loss']):.4f}, peak device memory "
          f"{peak / 2**30:.2f} GiB ({smi})")
    averages = prof.key_averages()
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in RANGES]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        sys.exit("profile_train_step: torch.profiler recorded no device "
                 "time on this card")
    print(f"device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e3 / (wall * 1e3):.3f} of the wall)")
    for name in RANGES:
        ms = sum(a.elapsed_time(b) for a, b in SPANS[name])
        print(f"  {ms:10.3f} ms  {ms / (wall * 1e3):.3f} of the wall  {name} "
              f"(its spans on the stream, {len(SPANS[name])} calls)")
    gemm_us = sum(e.self_device_time_total for e in kernels
                  if is_gemm(e.key))
    print(f"  {gemm_us / 1e3:10.3f} ms  {gemm_us / busy_us:.3f} of device "
          f"time  matrix products (cuBLAS, inside the ranges or not)")
    b = args.batch // args.microbatches
    fwd, both = attention_alone(cfg, b, args.seq)
    calls = cfg.num_layers * args.microbatches
    print(f"chunked attention alone at B={b} S={args.seq} (CUDA events): "
          f"forward {fwd:.3f} ms, forward + backward {both:.3f} ms; a step "
          f"runs {calls} of each and, under remat, {calls} more forwards: "
          f"{calls * (both + fwd):.1f} ms "
          f"({calls * (both + fwd) / (wall * 1e3):.3f} of the wall)")
    print("by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:40]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
