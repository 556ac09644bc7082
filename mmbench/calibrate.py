"""Read the numbers the check compares, to set a cell's limits.

    python3 -m mmbench.calibrate --workload <name> --seeds <s1,s2,...> \
        --control-seeds <c1,...> [--faults <f1,...>] --seconds <s>

In one process: the program's readings on each seed, then the control's
(the reference in TF32 in the program's place) and each planted fault's,
each over a window of ``--seconds`` at the cell's own size, so each
compares as many products as a run does.  Prints one line per run and a
JSON summary: per number the largest program reading (the lower reading)
and the smallest control reading (the upper).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from mmbench import faults, reference, run


def _ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = run.resolve(run.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    plan = [("program", s, None) for s in _ints(args.seeds)]
    plan += [("control", s, reference.control) for s in _ints(args.control_seeds)]
    seeds = _ints(args.control_seeds) or _ints(args.seeds)
    plan += [(f, seeds[0], faults.FAULTS[f]) for f in args.faults.split(",") if f]
    readings: dict[str, list[dict]] = {}
    for kind, seed, wrap in plan:
        out = run.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                           device="cuda", t0=time.perf_counter(), wrap=wrap)
        checked = out["checked"]
        row = {"seed": seed, **checked["worst"], "products": checked["compared"],
               "failed": checked["failed"],
               "tflops": out["view"].useful_flop / out["view"].window_s / 1e12}
        readings.setdefault(kind, []).append(row)
        print(json.dumps({"kind": kind, **row}), flush=True)
        del out
        torch.cuda.empty_cache()
    summary = {}
    for k in ("rows_err", "proj_err"):
        lower = max(r[k] for r in readings.get("program", [{k: 0.0}]))
        upper = min((r[k] for r in readings.get("control", [])), default=None)
        summary[k] = {"lower": lower, "upper": upper,
                      "ratio": upper / lower if upper and lower else None}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
