"""Print the dry run's cells as a markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1 \\
        --out results/dryrun
    python scripts/dryrun_table.py results/dryrun

One row per cell JSON of ``launch.dryrun`` on mesh ``1`` (the card's
grid): FLOP and bytes of one step, its peak live bytes, the roofline
bound on ``analysis.cost.DEFAULT_HW`` (the H100's data-sheet peaks) and
its dominant term, the useful ratio (model FLOP / counted FLOP), and
whether the peak fits the card's memory.  Skipped cells keep their
status.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.cost import DEFAULT_HW  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402


def rows(out: Path) -> list[str]:
    lines = ["| arch | shape | FLOP | bytes | peak live | bound (term) | "
             "useful | fits 80 GB |", "|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            path = out / f"{arch}__{shape}__1card.json"
            if not path.exists():
                lines.append(f"| {arch} | {shape} | missing | | | | | |")
                continue
            cell = json.loads(path.read_text())
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


if __name__ == "__main__":
    print("\n".join(rows(Path(sys.argv[1] if len(sys.argv) > 1
                                else "results/dryrun"))))
