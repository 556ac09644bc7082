"""Simulator CLI: schedule a virtual SUMMA and export the trace.

The port of ``python -m repro.sched``: the same options, the same JSON.

    PYTHONPATH=src python -m repro_torch.sched --grid 4 4 --extent 2048 \
        --blocks 16 --nonuniform --lookahead eq1 \
        --trace sched_trace.json --json sched_sim.json

Runs entirely on the host (numpy): grids of thousands of virtual devices
are fine.  ``--lookahead eq1`` resolves paper Eq. (1); ``--compare``
additionally simulates I=1 and reports the multi-issue speedup (the
paper's imbalance-absorption result).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.blocking import nonuniform_tiling, uniform_tiling
from repro_torch.sched.simulator import MachineModel, simulate
from repro_torch.sched.taskgraph import eq1_lookahead, from_tilings


def _tilings(extent: int, blocks: int, nonuniform: bool, seed: int):
    if nonuniform:
        return [
            nonuniform_tiling(extent, blocks, seed=seed + s) for s in range(3)
        ]
    return [uniform_tiling(extent, -(-extent // blocks)) for _ in range(3)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sched")
    ap.add_argument("--grid", type=int, nargs=2, default=(4, 4),
                    metavar=("P_ROW", "P_COL"))
    ap.add_argument("--extent", type=int, default=2048,
                    help="square matrix extent N")
    ap.add_argument("--blocks", type=int, default=16,
                    help="logical blocks per dimension (= SUMMA iterations)")
    ap.add_argument("--nonuniform", action="store_true",
                    help="paper §4.1 nonuniform block sizes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lookahead", default="eq1",
                    help="multiple-issue window I: an int, or 'eq1'")
    ap.add_argument("--itemsize", type=int, default=4)
    ap.add_argument("--flops", type=float, default=MachineModel.flops_per_s)
    ap.add_argument("--bandwidth", type=float, default=MachineModel.bytes_per_s)
    ap.add_argument("--latency", type=float, default=MachineModel.latency_s)
    ap.add_argument("--compare", action="store_true",
                    help="also simulate I=1 and report the speedup")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome/Perfetto trace JSON here")
    ap.add_argument("--json", default=None,
                    help="write the simulation summary JSON here")
    args = ap.parse_args(argv)

    p_row, p_col = args.grid
    row_t, inner_t, col_t = _tilings(
        args.extent, args.blocks, args.nonuniform, args.seed
    )
    if args.lookahead == "eq1":
        la = eq1_lookahead(p_row, p_col, inner_t.num_blocks)
    else:
        la = int(args.lookahead)
    machine = MachineModel(
        flops_per_s=args.flops, bytes_per_s=args.bandwidth,
        latency_s=args.latency, name="cli",
    )
    graph = from_tilings(
        p_row, p_col, row_t, inner_t, col_t,
        lookahead=la, itemsize=args.itemsize,
    )
    sim = simulate(graph, machine, trace=args.trace is not None)
    out = {"sim": sim.summary(), "tasks": graph.counts()}
    if args.compare:
        base = simulate(
            from_tilings(p_row, p_col, row_t, inner_t, col_t,
                         lookahead=1, itemsize=args.itemsize),
            machine,
        )
        out["serial_makespan_s"] = base.makespan_s
        out["multi_issue_speedup"] = (
            base.makespan_s / sim.makespan_s if sim.makespan_s > 0 else 1.0
        )
    print(json.dumps(out, indent=1))
    if args.trace:
        sim.write_chrome_trace(args.trace)
        print(f"# wrote {args.trace}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {args.json}")


if __name__ == "__main__":
    main()
