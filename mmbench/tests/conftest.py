"""Small copies of the benchmark's cells, for runs on the CPU."""
from __future__ import annotations

import pytest

from mmbench import run

#: configuration and traffic keys that shrink each cell to a CPU size;
#: every other key is the cell's own
SMALL = {
    "u32k.bsp30": ({"n": 256, "block": 32}, {"band_rows": 32, "k_blocks": 8}),
    "u32k.dense": ({"n": 256, "block": 32}, {"band_rows": 32, "k_blocks": 8}),
    "nu32k.dense": ({"n": 256, "num_blocks": 8, "avg_block": 32},
                    {"band_rows": 32, "tile": 32, "k_blocks": None}),
    "u32k.rank64": ({"n": 256, "block": 32},
                    {"band_rows": 32, "k_blocks": 8, "max_rank": 8}),
}


def small(cell: run.Cell) -> run.Cell:
    cfg, traffic = SMALL[cell.name]
    cell.config = dict(cell.config, **cfg)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


@pytest.fixture
def small_cell():
    bench = run.load_benchmark()
    return lambda name: small(run.resolve(bench, name))
