"""Print the dry run's cells as a markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1 \\
        --out results/dryrun
    python scripts/dryrun_table.py results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16 \\
        --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --mesh 2x16x16 --out results/dryrun
    python scripts/dryrun_table.py results/dryrun --per-device

One row per cell JSON of ``launch.dryrun`` on mesh ``1`` (the card's
grid): FLOP and bytes of one step, its peak live bytes, the roofline
bound on ``analysis.cost.DEFAULT_HW`` (the H100's data-sheet peaks) and
its dominant term, the useful ratio (model FLOP / counted FLOP), and
whether the peak fits the card's memory.  Skipped cells keep their
status.  With ``--per-device``, one row per cell that is not skipped:
the card's FLOP, bytes, peak and bound beside rank 0's FLOP, collective
bytes and peak on the production grids ``16x16`` and ``2x16x16``; a
peak above one card's memory is marked "(no)".
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.cost import DEFAULT_HW  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402


def _cell(out: Path, arch: str, shape: str, tag: str):
    path = out / f"{arch}__{shape}__{tag}.json"
    return json.loads(path.read_text()) if path.exists() else None


def rows(out: Path) -> list[str]:
    lines = ["| arch | shape | FLOP | bytes | peak live | bound (term) | "
             "useful | fits 80 GB |", "|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            cell = _cell(out, arch, shape, "1card")
            if cell is None:
                lines.append(f"| {arch} | {shape} | missing | | | | | |")
                continue
            if cell["status"] != "ok":
                lines.append(f"| {arch} | {shape} | {cell['status']} "
                             "| | | | | |")
                continue
            rep = cell["roofline"]
            peak = cell["memory_analysis"]["peak_live_bytes"]
            lines.append(
                f"| {arch} | {shape} | {cell['flops_per_device']:.4g} | "
                f"{cell['hbm_bytes_per_device']:.4g} | {peak / 1e9:.4g} GB "
                f"| {rep['bound_s']:.4g} s ({rep['dominant']}) | "
                f"{rep['useful_ratio']:.3f} | "
                f"{'yes' if peak <= DEFAULT_HW.hbm_capacity else 'no'} |")
    return lines


def per_device_rows(out: Path) -> list[str]:
    lines = ["| arch | shape | 1 card: FLOP | bytes | peak | bound (term) "
             "| 16x16, rank 0: FLOP | coll. bytes | peak | 2x16x16, rank 0: "
             "FLOP | coll. bytes | peak |", "|---|---|" + "---|" * 10]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            cells = [_cell(out, arch, shape, t)
                     for t in ("1card", "1pod", "2pod")]
            if all(c is not None and c["status"].startswith("skip")
                   for c in cells):
                continue  # the reference's skips
            row = f"| {arch} | {shape} |"
            for tag, cell in zip(("1card", "1pod", "2pod"), cells):
                n = 4 if tag == "1card" else 3
                if cell is None or cell["status"] != "ok":
                    status = "missing" if cell is None else cell["status"]
                    row += f" {status} |" + " |" * (n - 1)
                    continue
                peak = cell["memory_analysis"]["peak_live_bytes"]
                fits = "" if peak <= DEFAULT_HW.hbm_capacity else " (no)"
                row += f" {cell['flops_per_device']:.4g} |"
                if tag == "1card":
                    rep = cell["roofline"]
                    row += (f" {cell['hbm_bytes_per_device']:.4g} | "
                            f"{peak / 1e9:.4g} GB{fits} | {rep['bound_s']:.4g}"
                            f" s ({rep['dominant']}) |")
                else:
                    row += (f" {cell['collective_bytes_per_device']:.4g} | "
                            f"{peak / 1e9:.4g} GB{fits} |")
            lines.append(row)
    return lines


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    out = Path(args[0] if args else "results/dryrun")
    print("\n".join(per_device_rows(out) if "--per-device" in sys.argv
                    else rows(out)))
