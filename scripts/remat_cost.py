"""What remat costs a train step, counted on the meta device.

    PYTHONPATH=src python scripts/remat_cost.py [--arch llama3.2-1b] \\
        [--shape train_4k] [--microbatches 16]

Counts one train step of the cell (``launch.dryrun.count_cell``, nothing
allocated) with the units recomputed in the backward and without, and
prints both counts, their difference (the recompute) and its share of
the step, with the bound of each on ``analysis.cost.DEFAULT_HW``.  It
also prints the part of the recompute the reference's remat does not
pay: ``torch.utils.checkpoint`` recomputes a unit's whole forward, where
XLA drops the recomputed product nothing in the backward reads, the
unit's last (its FFN's down projection, 2·B·S·d_ff·d_model a unit and
microbatch; ``tests/test_torch_analysis.py`` holds this gap against the
reference's count exactly at the smoke configs).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis import cost  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--microbatches", type=int,
                    default=dryrun.DEFAULT_MICROBATCHES)
    args = ap.parse_args(argv)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    ctx = dryrun.make_ctx(Grid.local("meta"), False)
    mb = max(1, min(args.microbatches, shape.global_batch))
    counts = {remat: dryrun.count_cell(cfg, shape, ctx, mb, remat=remat)
              for remat in (True, False)}
    print(f"{cfg.name} {shape.name} ({shape.global_batch} x "
          f"{shape.seq_len} in {mb} microbatches), per step:")
    for remat, (wc, mem) in counts.items():
        rep = cost.roofline(wc.flops, wc.hbm_bytes, wc.wire_bytes, chips=1)
        print(f"  remat={remat}: {wc.flops:.6g} FLOP, {wc.hbm_bytes:.6g} "
              f"bytes, peak live {mem.peak_live_bytes:.6g} B; bound "
              f"{rep.bound_s:.6g} s ({rep.dominant})")
    (on, _), (off, _) = counts[True], counts[False]
    extra_f, extra_b = on.flops - off.flops, on.hbm_bytes - off.hbm_bytes
    print(f"  the recompute: {extra_f:.6g} FLOP ({extra_f / on.flops:.4f} "
          f"of the step), {extra_b:.6g} bytes ({extra_b / on.hbm_bytes:.4f})")
    b = shape.global_batch // mb
    dead = cfg.units * 2 * b * shape.seq_len * cfg.d_ff * cfg.d_model * mb
    print(f"  of it, the units' last products the reference's remat drops: "
          f"{dead:.6g} FLOP ({dead / on.flops:.4f} of the step, "
          f"{dead / extra_f:.4f} of the recompute)")


if __name__ == "__main__":
    main()
