"""The multi-rank mode (``multirank``) on four gloo ranks on the CPU at a
small size: a sound run is correct, each planted fault and the control
are not, unequal draws and a failed rank fail the run, and a one-card
cell's result keeps its keys.

The four-card cell ``u32k.bsp30.grid2x2`` is not in ``BENCHMARK.json``
(its rate spread too widely from run to run to hold a bound); its entries
wait in ``grid_cell.json`` beside this file, which the tests add to the
benchmark's own."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from mmbench import multirank, run

GRID = "u32k.bsp30.grid2x2"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
#: the entries of ``BENCHMARK.json`` that the four-card cell would add
ENTRIES = Path(__file__).with_name("grid_cell.json")


def _bench() -> dict:
    bench = run.load_benchmark()
    for key, extra in json.loads(ENTRIES.read_text()).items():
        bench[key] = bench[key] + extra
    return bench


def _small_grid_cell() -> run.Cell:
    cell = run.resolve(_bench(), GRID)
    cell.config = dict(cell.config, n=1024, block=64)
    cell.traffic = dict(cell.traffic, band_rows=64, k_blocks=16)
    return cell


def _launch(trace=False, **kw):
    rc, lines = multirank.launch(_small_grid_cell(), seed=2**31 + 13,
                                 seconds=0.3, trace=trace,
                                 t0=time.perf_counter(), device="cpu", **kw)
    return rc, lines


def test_the_grid_cells_entries_resolve():
    cell = run.resolve(_bench(), GRID)
    assert cell.chips == 4 and cell.config["grid"] == [2, 2]
    assert set(cell.limits) == {"rows_err", "proj_err", "ranks_differ"}
    assert sorted(m["name"] for m in cell.end_to_end) == [
        "peak_mem_gib", "setup_s", "useful_tflops.grid"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(run.metric_reader(m["name"]))


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_sound_run_is_correct(trace_on):
    cell = _small_grid_cell()
    rc, lines = _launch(trace=trace_on)
    assert rc == 0
    out = json.loads(lines[-1])
    assert list(out)[:5] == KEYS and list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2
    assert out["device"]["count"] == 4
    assert [x for x in lines[:-1] if x.startswith("check ")] == lines[:-1]
    if trace_on:
        assert out["traced"].startswith(
            f"rank 0 of 4: {multirank.TRACE_PRODUCTS} products")
        # the counter is read on the CPU too; device time is not
        assert out["metrics"]["grid.recv_gib.grid"]["value"] > 0
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("wrap,ranks", [
    ("half_k", [3]),  # B's second half zeroed on rank 3 alone
    ("stale", [0]),
    ("altered", [0]),
    ("altered", [2]),  # a C that differs on rank 2 alone
    ("no_exchange", [0, 1, 2, 3]),
    ("control", [0, 1, 2, 3]),
])
def test_faults_and_the_control_fail_rank_0s_check(wrap, ranks):
    rc, lines = _launch(wrap=wrap, wrap_ranks=ranks)
    assert rc == 0
    out = json.loads(lines[-1])
    assert out["correct"] is False


def test_unequal_draws_fail_set_up():
    rc, lines = _launch(perturb_rank=2)
    assert rc != 0 and not lines


def test_a_failed_rank_fails_the_run_and_ends_the_others():
    """Rank 1 refuses its arguments; the others wait to join the world
    until the launcher ends them."""
    t = time.monotonic()
    rc, lines = _launch(wrap="no such fault", wrap_ranks=[1])
    assert rc != 0 and not lines
    assert time.monotonic() - t < 120


def test_a_one_card_cells_result_keys_are_unchanged(small_cell):
    cell = small_cell("u32k.bsp30")
    result = run.run_cell(cell, seed=5, seconds=0.1, trace=False,
                          device="cpu", t0=time.perf_counter())
    out, _ = run.result_line(cell, result, False)
    assert list(out) == KEYS + ["check"]
    assert out["device"]["count"] == 1


def test_the_grid_readers_on_a_made_up_trace():
    """Two traced products of a ten-product window: per-product readings
    divide by the traced products, paces take the window's median."""
    from mmbench.trace import Interval, Trace

    iv = [Interval("ncclDevKernel_Broadcast", 0, 300, True),
          Interval("bsmm_kernel", 200, 500, True),
          Interval("ncclDevKernel_AllGather", 600, 700, True),
          Interval("copy", 800, 900, False)]
    tr = Trace(iv, [(0, 450), (500, 950)], [], 0, (0, 1000))
    peak = {"flops": 1e12, "bytes_per_s": 1e12}
    view = run.View(products=10, window_s=0.02, setup_s=1.0, peak_bytes=0,
                    useful_flop=1e10, call_host_s=[1e-3] * 10,
                    product_s=[2e-3] * 9 + [9e-3], counters={},
                    launches={"bsmm": 1.0}, kernel_work={"bsmm": (1e8, 1e8)},
                    peak=peak, trace=tr, cards=4)
    read = {m: run.metric_reader(m)(view) for m in (
        "grid.comm_ms.grid", "grid.exposed_comm_ms.grid",
        "bsmm_roofline.grid", "product_mfu.grid", "device.idle.grid")}
    assert read["grid.comm_ms.grid"] == pytest.approx(0.4 / 2)
    assert read["grid.exposed_comm_ms.grid"] == pytest.approx(0.3 / 2)
    assert read["bsmm_roofline.grid"] == pytest.approx(100 * 1e-4 * 2 / 3e-4)
    assert read["product_mfu.grid"] == pytest.approx(
        100 * 1e9 / 2e-3 / 4e12)
    assert read["device.idle.grid"] == pytest.approx(
        100 * (1 - 0.7e-3 / 2 / 2e-3))
