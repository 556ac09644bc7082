r"""End-to-end training on the PyTorch port: a small LLaMA-style model for
a few hundred steps on the deterministic synthetic stream.

    PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_e2e.py --device cpu --steps 12 \
        --ckpt-every 5 --global-batch 4 --seq 32

``launch.train`` with the arguments of the JAX version
(``examples/train_e2e.py``): llama3.2-1b's smoke config, 8 sequences of
256 tokens a step in 2 microbatches, a checkpoint every 50 steps.  Shows
the loss curve (the loss must fall), then the resume: a run restarted
from the last checkpoint before the end (a copy of it, alone in a fresh
directory) retraces the uninterrupted run's losses — its first step
exactly, the rest within 1e-3 (on the card a backward's atomic
additions may round in another order).
"""
import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.launch.train import main as train_main  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(_ROOT, "build", "torch_train_e2e"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    full = os.path.join(args.ckpt_dir, "full")
    resumed = os.path.join(args.ckpt_dir, "resumed")
    for d in (full, resumed):
        shutil.rmtree(d, ignore_errors=True)

    def run(ckpt_dir, *extra):
        return train_main([
            "--arch", "llama3.2-1b", "--smoke",
            "--steps", str(args.steps),
            "--global-batch", str(args.global_batch),
            "--seq", str(args.seq),
            "--microbatches", "2",
            "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(args.ckpt_every),
            "--log-every", "20",
            "--device", args.device,
            *extra,
        ])

    losses = run(full)
    n = len(losses)
    print("\nloss curve (every ~20 steps):")
    for i in range(0, n, max(n // 15, 1)):
        bar = "#" * int(max(losses[i], 0) / max(losses[0], 1e-9) * 40)
        print(f"  step {i + 1:4d}  {losses[i]:8.4f}  {bar}")
    assert losses[-1] < losses[0], "training must reduce loss"
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over {n} steps")

    # resume from the last checkpoint before the end
    last = args.ckpt_every * ((args.steps - 1) // args.ckpt_every)
    if last == 0:
        return {"losses": losses}
    name = next(f for f in os.listdir(full) if f.startswith("step_")
                and int(f.split("_")[1]) == last)
    shutil.copytree(os.path.join(full, name), os.path.join(resumed, name))
    again = run(resumed, "--resume")
    want = losses[last:]
    assert len(again) == len(want), (len(again), len(want))
    np.testing.assert_allclose(again[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(again, want, rtol=1e-3)
    print(f"resumed from step {last}: {len(again)} steps retrace the "
          f"uninterrupted run (first loss {again[0]:.6f} = {want[0]:.6f})")
    return {"losses": losses, "resumed": again}


if __name__ == "__main__":
    main()
