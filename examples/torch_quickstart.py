"""Quickstart: task-based SUMMA in five minutes, on the PyTorch port.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --ranks 8

The paper's algorithm family: the procedural baseline, multiple-issue
task-based SUMMA (Eq. 1 lookahead) and the all-gather extreme, each held
against the dense oracle, then the over-decomposition of K into more
panels.  By default it runs on the 1x1 grid of one card, its local
products on the hand-written ``tiled_matmul`` kernel (on the CPU its
plain version); ``--ranks 8`` runs
a 2x4 grid of eight gloo processes on the CPU, where the JAX version
(``examples/quickstart.py``) emulates a 2x4 mesh.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    DistributedMatmul,
    Grid,
    multi_issue_limit,
    reference_matmul,
)
from repro_torch.launch.mesh import spawn_gloo_ranks  # noqa: E402

#: a product's largest error, as a share of the oracle's largest entry
HOLD = 1e-4


def run(grid: Grid, say=print) -> dict[str, float]:
    """The products on ``grid``; returns each one's largest error as a
    share of the oracle's largest entry, and raises past ``HOLD``."""
    p_row, p_col = grid.sizes
    say(f"grid: {grid.shape} on {grid.device}")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(512, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1024, 768)).astype(np.float32))
    a, b = a.to(grid.device), b.to(grid.device)
    want = reference_matmul(a, b)
    scale = float(want.abs().max())

    # paper Eq. (1): how many SUMMA iterations are in flight
    k_steps = 8
    say(f"multiple-issue limit I(P_row={p_row}, P_col={p_col}, "
        f"K={k_steps}) = {multi_issue_limit(p_row, p_col, k_steps)}")

    errs = {}
    runs = [(s, k_steps) for s in ("procedural", "taskbased", "allgather")]
    # over-decomposition: more K panels -> finer pipeline slots
    runs += [("taskbased", kb) for kb in (4, 8, 16)]
    for strategy, kb in runs:
        mm = DistributedMatmul(grid, strategy=strategy, k_blocks=kb,
                               local_matmul="pallas")
        err = float((mm(a, b) - want).abs().max()) / scale
        errs[f"{strategy}/k_blocks={kb}"] = err
        say(f"{strategy:11s} k_blocks={kb:3d}: max |err| / max |C| = "
            f"{err:.2e}")
        if not err <= HOLD:
            raise AssertionError(f"{strategy} k_blocks={kb}: {err} > {HOLD}")
    return errs


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1, choices=[1, 8],
                    help="8: a 2x4 grid of gloo processes on the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ranks == 1:
        return run(Grid.local(args.device))
    if args.device != "cpu":
        raise SystemExit("--ranks 8 runs gloo processes on the CPU: "
                         "add --device cpu")
    if args.rank is None:
        outs = spawn_gloo_ranks(os.path.abspath(__file__),
                                ["--device", "cpu", "--ranks", "8"], 8)
        print(outs[0], end="")
        return {}
    torch.distributed.init_process_group(
        "gloo", init_method=args.init_method, rank=args.rank, world_size=8)
    try:
        torch.set_num_threads(1)
        grid = Grid.from_process_group(2, 4, device="cpu")
        return run(grid, say=print if args.rank == 0 else lambda *a: None)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
