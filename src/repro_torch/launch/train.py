"""End-to-end training driver.

The port of ``repro.launch.train``, flag for flag, plus ``--device``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --steps 60 --global-batch 8 --seq 128 --ckpt-dir ckpt \\
        [--resume] [--fail-at-step 30] [--microbatches 2] \\
        [--matmul-strategy summa] [--dp 1 --tp 1] [--device cpu]

Features exercised here (the fault-tolerance story):
* periodic atomic checkpoints + ``--resume`` (restores params/opt/step and
  the data stream resumes deterministically at the right batch),
* ``--fail-at-step N`` kills the process mid-run to simulate a node
  failure (exit code 42, after the step's checkpoint); a following
  ``--resume`` run must continue losslessly,
* async host data prefetch (``train.data.Prefetcher``),
* optional task-based-SUMMA matmul strategy (the paper's algorithm in the
  training loop, forward and backward).

With ``--dp`` times ``--tp`` more than one (under an initialised
``torch.distributed`` world of dp·tp processes) the state is sharded
(``train.train_step.make_train_state``): every rank draws the same
global batch and trains on its rows; checkpoints hold whole leaves,
written by rank 0, and restore onto any grid.

Initial weights come from a ``torch.Generator`` seeded with ``--seed`` on
the device; the run is on ``cuda`` unless ``--device`` names another.
Checkpoints are in the reference's format (``train.checkpoint``).
``main`` returns the losses of the steps it ran.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.launch.mesh import make_host_grid
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.data import Prefetcher, SyntheticData
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--matmul-strategy", default="xla",
                    choices=["xla", "summa", "allgather", "auto"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = torch.device(args.device)
    grid = make_host_grid(args.dp, args.tp, device=device)
    ctx = ParallelCtx(grid, matmul_strategy=args.matmul_strategy)

    opt = make_optimizer(
        OptimizerConfig(
            name=args.optimizer, peak_lr=args.lr,
            warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        )
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = ts.make_train_state(cfg, ctx, opt, generator=generator,
                                device=device)

    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            tree = ckpt.restore_checkpoint(
                args.ckpt_dir, last, ts.state_target(state), device=device,
                shardings=ts.state_shardings(state, ctx)
                if grid.axis_size(grid.axis_names) > 1 else None, grid=grid)
            ts.load_state_tree(state, tree)
            start_step = last
            print(f"[resume] restored step {last} from {args.ckpt_dir}")

    data = SyntheticData(cfg, args.global_batch, args.seq, seed=args.seed)
    step_fn = ts.build_train_step(cfg, ctx, opt,
                                  microbatches=args.microbatches)

    def tree():
        return ts.state_tree(state, ctx)

    manager = (
        ckpt.CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                               write=grid.rank == 0)
        if args.ckpt_dir
        else None
    )
    pre = Prefetcher(data, start_step=start_step)
    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            got_step, batch = pre.next()
            assert got_step == step, (got_step, step)
            state, metrics = step_fn(state, batch)
            if args.fail_at_step is not None and step + 1 == args.fail_at_step:
                # simulate a node failure AFTER the optimizer step but
                # potentially before the checkpoint - worst case
                if manager:
                    manager.maybe_save(step + 1, tree)
                print(f"[failure-sim] dying at step {step + 1}", flush=True)
                sys.exit(42)
            if manager:
                manager.maybe_save(step + 1, tree)
            loss = float(metrics["loss"])
            losses.append(loss)
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt = time.time() - t0
                print(
                    f"step {step + 1:5d}  loss {loss:8.4f}  "
                    f"ce {float(metrics['ce']):8.4f}  "
                    f"({dt / max(len(losses), 1):.2f}s/step)",
                    flush=True,
                )
    finally:
        pre.stop()
    if manager:
        final = tree()
        if manager.write:
            ckpt.save_checkpoint(args.ckpt_dir, args.steps, final)
    print(
        f"[done] steps {start_step}->{args.steps}  "
        f"first loss {losses[0]:.4f}  last loss {losses[-1]:.4f}"
    )
    return losses


if __name__ == "__main__":
    main()
