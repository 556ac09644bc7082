"""Serving entry point: batched prefill + autoregressive decode.

The port of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --batch 4 --prompt-len 4096 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
        --arch llama3.2-1b --batch 4 --prompt-len 64 --gen 32

Runs greedy decoding over synthetic prompts (a seeded
``torch.Generator``) on random weights and reports prefill/decode
throughput; ``--device`` names the device (``cuda`` unless told
otherwise).  With ``--dp``/``--tp`` over one rank (one process per rank
under an initialised ``torch.distributed``) the parameters are sharded
after init (``dist.partitioning.shard_params``, as the reference's
``param_shardings`` places them), each DP rank holds its rows of the
caches, the KV cache is sequence-sharded over tp and decode attention
uses the LSE-combined partial-softmax path.

``--continuous`` switches from the fixed-shape batch loop to the
continuous-batching scheduler (``serve.scheduler``) over a ragged
arrival trace; ``--paged`` additionally backs the KV cache with page
pools (``serve.pages``).  ``--plan-cache plans.json`` persists tuned
schedule winners + the traffic distribution across processes
(``serve.plan_service``) — a warm restart re-applies stored winners with
zero tuner runs.

``main`` returns the generated tokens ``(batch, gen)``, or the
scheduler's result dict.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import (param_shardings, shard_params,
                                            spec_of)
from repro_torch.launch.mesh import make_host_grid
from repro_torch.models import layers as L
from repro_torch.models.model import init_model
from repro_torch.serve import engine
from repro_torch.serve.plan_service import plan_service


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_continuous(params, cfg, ctx, args):
    from repro_torch.serve.scheduler import Scheduler, ragged_trace

    max_len = args.prompt_len + args.gen
    sched = Scheduler(
        params, cfg, ctx, n_slots=args.batch, max_len=max_len,
        mode="continuous", backend="paged" if args.paged else "dense",
    )
    reqs = ragged_trace(
        4 * args.batch,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        gen_lens=(max(args.gen // 4, 1), args.gen),
        vocab=cfg.vocab_size, seed=args.seed,
    )
    res = sched.run(reqs)
    print(
        f"continuous[{res['backend']}]: {res['requests']} requests in "
        f"{res['steps']} steps   {res['tokens_per_s']:,.0f} tok/s   "
        f"p50 {res['p50_step_ms']:.1f} ms   p99 {res['p99_step_ms']:.1f} ms"
    )
    return res


def param_bytes(params, grid) -> tuple[int, int]:
    """(bytes of the whole weights, bytes this rank holds): on a sharded
    model (``dist.partitioning.shard_params``) the bytes of its blocks,
    on a whole one the bytes it would hold under ``param_shardings`` on
    ``grid``."""
    named = dict(params.named_parameters())
    shapes = {n: tuple(getattr(p, "full_shape", p.shape))
              for n, p in named.items()}
    whole = sum(math.prod(s) * named[n].element_size()
                for n, s in shapes.items())
    if any(spec_of(p) is not None for p in named.values()):
        return whole, sum(p.numel() * p.element_size()
                          for p in named.values())
    specs = param_shardings(shapes, grid)
    shape = dict(grid.shape)
    shard = 0
    for name, p in named.items():
        n = p.numel() * p.element_size()
        for entry in specs[name]:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    n //= shape[axis]
        shard += n
    return whole, shard


def prompt_inputs(cfg, batch: int, prompt_len: int, device) -> dict:
    """The synthetic prompts of the fixed batch (seed 1, drawn on the
    host): tokens, and for a VLM zero patch embeddings over the first
    quarter with M-RoPE positions."""
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len),
        generator=torch.Generator().manual_seed(1),
    ).to(device)
    if cfg.family != "vlm":
        return {"tokens": prompts}
    s_vis = prompt_len // 4
    return {
        "tokens": prompts[:, s_vis:],
        "embeds": torch.zeros((batch, s_vis, cfg.d_model),
                              dtype=L.torch_dtype(cfg.dtype), device=device),
        "positions": torch.arange(prompt_len, device=device)[
            None, :, None].expand(batch, prompt_len, 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--matmul-strategy", default="xla",
        choices=["xla", "summa", "allgather", "auto"],
    )
    ap.add_argument("--max-len", type=int, default=None,
                    help="KV cache capacity (default: prompt-len + gen)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a ragged trace via the scheduler")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV backend (implies --continuous)")
    ap.add_argument("--plan-cache", default=None,
                    help="JSON path to load/save tuned plan winners")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch has no autoregressive serving")
    device = torch.device(args.device)
    grid = make_host_grid(args.dp, args.tp, device=device)
    ctx = ParallelCtx(grid, matmul_strategy=args.matmul_strategy)
    svc = plan_service()
    if args.plan_cache and os.path.exists(args.plan_cache):
        n = svc.load(args.plan_cache)
        print(f"plan cache: loaded {n} winners from {args.plan_cache}")
    # Derive all projection schedules once, before the first request.
    engine.warm_matmul_plans(cfg, ctx, args.batch, args.prompt_len)
    if args.plan_cache:
        svc.save(args.plan_cache)
        print(
            f"plan cache: saved {len(svc.table)} winners "
            f"(tunes={svc.stats['tunes']} hits={svc.stats['hits']})"
        )
    max_len = args.max_len or (args.prompt_len + args.gen)
    # The engine never corrupts state past capacity (writes are dropped),
    # but the logits would be wrong — this entry point refuses up front.
    s_c = engine.cache_len(cfg, max_len)
    if cfg.window is None and args.prompt_len + args.gen > s_c:
        raise engine.CacheCapacityError(
            f"prompt {args.prompt_len} + gen {args.gen} = "
            f"{args.prompt_len + args.gen} tokens > cache capacity {s_c}; "
            "raise --max-len"
        )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(cfg, generator=gen, device=device, ep=ctx.tp_size)
    if grid.axis_size(grid.axis_names) > 1:
        shard_params(params, grid)
    whole, shard = param_bytes(params, grid)
    print(f"params: {whole:,} bytes whole; {shard:,} held by a rank")
    if args.continuous or args.paged:
        with torch.inference_mode():
            return _run_continuous(params, cfg, ctx, args)

    inputs = prompt_inputs(cfg, args.batch, args.prompt_len, device)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = engine.prefill(params, inputs, cfg, ctx,
                                       max_len=max_len)
        tokens = logits.argmax(dim=-1)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out_tokens = [tokens]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = engine.decode_step(params, cache, tokens, cfg,
                                               ctx)
            tokens = logits.argmax(dim=-1)
            out_tokens.append(tokens)
        _sync(device)
        t_decode = time.perf_counter() - t0

    gen_tokens = torch.stack(out_tokens, dim=1).cpu().numpy()
    print(f"generated shape: {gen_tokens.shape}")
    print(f"sample: {gen_tokens[0][:16].tolist()}")
    print(
        f"prefill: {args.batch * args.prompt_len / t_prefill:,.0f} tok/s   "
        f"decode: {args.batch * (args.gen - 1) / max(t_decode, 1e-9):,.0f} "
        "tok/s"
    )
    print(f"wall: prefill {t_prefill:.6f} s, decode {t_decode:.6f} s over "
          f"{args.gen - 1} steps")
    return gen_tokens


if __name__ == "__main__":
    main()
