#!/usr/bin/env python3
"""Where the time of one serving decode step goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/profile_serve_decode.py            # llama3.2-1b
    python3 scripts/profile_serve_decode.py --arch recurrentgemma-9b --batch 2

It builds the architecture at full width and depth (``init_model``,
seed 0, bf16: the models of ``chip_smoke.py`` [serve]), prefills
``--batch`` prompts of ``--prompt`` tokens and then decodes in four
ways: ``decode_step`` in a loop (the fixed batch of ``launch.serve``),
the same on an int8 cache (``kv_quant``; attention archs only), and one
step of ``serve.scheduler.Scheduler`` with every slot live, on dense
ring caches and on paged pools (attention archs without a window).  For
each it prints the wall of a step (host clock, ``--steps`` steps ending
in ``synchronize``), then traces four more steps with ``torch.profiler``
and prints per step the device's busy time and share of the wall, the
kernels launched, the host's calls that copy or wait for the card, and
the device time grouped into matrix products, cache writes and gathers,
and the rest.  It exits non-zero if the
profiler records no device time on the card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.dist.context import ParallelCtx  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: E402

TRACED = 4
#: the host's calls that copy between host and card or wait for the card
HOST_WAITS = ("cudaMemcpyAsync", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "aten::_local_scalar_dense")


def group(name: str) -> str:
    """The part of a decode step a device kernel belongs to."""
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "sm90_xmma", "cutlass",
                              "cublas", "gemv", "splitk")):
        return "matrix products (cuBLAS)"
    if any(k in low for k in ("index", "gather", "scatter")):
        return "cache writes and gathers (index, gather)"
    return "elementwise, norms, softmax, reductions, copies"


def engine_loop(model, cfg, ctx, tokens, max_len):
    """A prefill, then ``step()`` runs one ``decode_step`` on the cache."""
    logits, cache = engine.prefill(model, {"tokens": tokens}, cfg, ctx,
                                   max_len=max_len)
    state = {"cache": cache, "tok": logits.argmax(-1)}

    def step():
        logits, state["cache"] = engine.decode_step(
            model, state["cache"], state["tok"], cfg, ctx)
        state["tok"] = logits.argmax(-1)
    return step


def scheduler_loop(model, cfg, tokens, max_len, backend):
    """A scheduler with every slot admitted (step 0 runs the prefills);
    ``step()`` runs one scheduler step: decode, argmax to the host."""
    sched = Scheduler(model, cfg, ParallelCtx(None), n_slots=tokens.shape[0],
                      max_len=max_len, backend=backend)
    prompts = tokens.cpu().numpy().astype(np.int32)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p,
                             max_new_tokens=max_len - len(p)))
    sched.step(0)
    count = [1]

    def step():
        sched.step(count[0])
        count[0] += 1
    return step


def measure(label: str, step, steps: int) -> None:
    with torch.inference_mode():
        step()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACED):
                step()
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) / TRACED
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events) / TRACED
    if busy_us == 0:
        sys.exit("profile_serve_decode: torch.profiler recorded no device "
                 "time on this card")
    launches = sum(e.count for e in events) / TRACED
    print(f"{label}: {wall * 1e3:.3f} ms a step ({steps} steps, host clock "
          f"ending in synchronize); traced {traced * 1e3:.3f} ms a step: "
          f"device busy {busy_us / 1e3:.3f} ms ({busy_us / 1e3 / (traced * 1e3):.3f}"
          f" of the traced wall), {launches:.0f} kernels a step", flush=True)
    waits = {e.key: e.count / TRACED for e in prof.key_averages()
             if e.key in HOST_WAITS}
    print("  host calls a step that copy or wait: " + ", ".join(
        f"{k} x{waits.get(k, 0):.0f}" for k in HOST_WAITS), flush=True)
    groups: dict[str, float] = {}
    for e in events:
        groups[group(e.key)] = groups.get(group(e.key), 0.0) + (
            e.self_device_time_total / TRACED)
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.3f} ms  {us / busy_us:.3f} of device time  "
              f"{name}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / TRACED / 1e3:9.3f} ms  "
              f"x{e.count / TRACED:<5.0f} {e.key[:90]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="llama3.2-1b")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--prompt", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=16)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_serve_decode: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    model = init_model(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(1))
    max_len = args.prompt + 2 * (args.steps + TRACED + 2)
    print(f"{cfg.name} ({cfg.num_layers} layers), bf16, B={args.batch}, "
          f"decoding after a prompt of {args.prompt} tokens", flush=True)
    attn = "attn" in cfg.block_pattern + cfg.tail
    with torch.inference_mode():
        loops = [("decode_step", engine_loop(model, cfg, ParallelCtx(None),
                                             tokens, max_len))]
        if attn:
            loops.append(("decode_step, kv_quant", engine_loop(
                model, cfg, ParallelCtx(None, kv_quant=True), tokens,
                max_len)))
        loops.append(("Scheduler.step, dense", scheduler_loop(
            model, cfg, tokens, max_len, "dense")))
        if attn and cfg.window is None:
            loops.append(("Scheduler.step, paged", scheduler_loop(
                model, cfg, tokens, max_len, "paged")))
    for label, step in loops:
        measure(label, step, args.steps)


if __name__ == "__main__":
    main()
