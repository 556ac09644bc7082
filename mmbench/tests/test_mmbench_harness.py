"""The runner: discovery by name, the result line, the check's verdict on
planted faults and on the control, and what a run imports."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from mmbench import faults, reference, run, trace
from mmbench.tests.conftest import SMALL

CELLS = sorted(SMALL)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, *, trace_on=False, wrap=None, seed=2**31 + 11, seconds=0.2):
    out = run.run_cell(cell, seed=seed, seconds=seconds, trace=trace_on,
                       device="cpu", t0=time.perf_counter(), wrap=wrap)
    return run.result_line(cell, out, trace_on)


def test_every_cell_resolves_by_name():
    bench = run.load_benchmark()
    assert {w["name"] for w in bench["workloads"]} == set(CELLS)
    for w in bench["workloads"]:
        cell = run.resolve(bench, w["name"])
        for hook in ("structure", "operand_a", "useful_flop", "kernel_work",
                     "reference_a", "reference_b_rows", "Program"):
            assert hasattr(cell.route, hook), (cell.name, hook)
        assert set(cell.limits) == {"rows_err", "proj_err"}
        assert cell.end_to_end and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(small_cell, name, trace_on):
    cell = small_cell(name)
    out, lines = _run(cell, trace_on=trace_on)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert set(keys) <= set(KEYS) | {"breakdown", "check"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    want = cell.per_layer if trace_on else cell.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if not trace_on:
        assert set(out["metrics"]) == {m["name"] for m in want}
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
    for k, v in out["check"].items():
        assert v["value"] <= v["limit"]
        assert any(line.startswith(f"check {k} ") for line in lines)
    json.dumps(out)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_are_not_correct(small_cell, name, fault):
    out, _ = _run(small_cell(name), wrap=faults.FAULTS[fault], seconds=0.3)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(small_cell, name):
    out, _ = _run(small_cell(name), wrap=reference.control)
    assert out["correct"] is False


def _copy_bench(dst: Path) -> Path:
    root = run.ROOT
    shutil.copytree(root / "mmbench", dst / "mmbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(root / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


_SMALL_RUN = """
import json, sys, time
from mmbench import run
from mmbench.tests.conftest import small, SMALL
SMALL.update(json.loads(sys.argv[2]))
cell = small(run.resolve(run.load_benchmark(), sys.argv[1]))
for trace_on in (False, True):
    out, _ = run.result_line(cell, run.run_cell(cell, seed=5, seconds=0.2,
        trace=trace_on, device="cpu", t0=time.perf_counter()), trace_on)
    print(json.dumps(out))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _small_run(root: Path, name: str, extra: dict | None = None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SMALL_RUN, name, json.dumps(extra or {})],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    *outs, modules = [json.loads(x) for x in proc.stdout.splitlines()]
    return outs, modules


def test_a_new_cell_route_and_metric_are_found_as_new_files(tmp_path):
    root = _copy_bench(tmp_path)
    os.symlink(run.ROOT / "src", root / "src")
    mm = root / "mmbench"
    (mm / "traffic" / "bsp10_dense_b.json").write_text(json.dumps(
        dict(json.loads((mm / "traffic" / "bsp30.json").read_text()),
             route="onesided", a_fill=0.1)))
    (mm / "routes" / "onesided.py").write_text(
        "from mmbench.routes.blocksparse import *  # noqa\n"
        "from mmbench.routes.blocksparse import structure as _s\n"
        "def structure(cfg, traffic, seed):\n"
        "    st = _s(cfg, traffic, seed)\n"
        "    st['b_mask'] = st['b_mask'] | True\n"
        "    return st\n")
    (mm / "metrics" / "useful_gflop.py").write_text(
        "def read(view):\n    return view.useful_flop / view.products / 1e9\n")
    (mm / "workloads" / "u32k.bsp10.json").write_text(
        (mm / "workloads" / "u32k.bsp30.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "u32k.bsp10", "config": bench[
        "workloads"][0]["config"], "traffic": "bsp10_dense_b", "chips": 1,
        "why": "a test cell"})
    bench["per_layer"].append({"name": "useful_gflop", "unit": "GFLOP",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole product", "moves": "useful_tflops",
                               "workloads": ["u32k.bsp10"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    outs, _ = _small_run(root, "u32k.bsp10",
                         {"u32k.bsp10": SMALL["u32k.bsp30"]})
    assert all(o["correct"] for o in outs)
    assert "useful_gflop" in outs[1]["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_a_run_imports_no_jax_and_the_reference_none_of_the_program(name):
    _, modules = _small_run(run.ROOT, name)
    assert "repro_torch" in modules
    assert not set(modules) & set(run.FORBIDDEN)
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; import mmbench.reference, "
         "mmbench.cases, mmbench.count, mmbench.trace; print(sorted({m.split('.')"
         "[0] for m in sys.modules}))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    loaded = set(eval(proc.stdout))
    assert not loaded & ({"repro_torch"} | set(run.FORBIDDEN))


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-m", "mmbench.run", "--workload", "u32k.bsp30",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=run.ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    root = _copy_bench(tmp_path)  # BENCHMARK.json and mmbench/ alone
    proc = subprocess.run(
        [sys.executable, "-c", _SMALL_RUN, "u32k.bsp30", "{}"], cwd=root,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_trace_reduction_on_a_made_up_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "mmbench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "mmbench.call",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "mmbench.call",
         "ts": 14, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 20, "dur": 5, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "void bsmm_kernel<float>",
         "ts": 14, "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "elementwise",
         "ts": 40, "dur": 20, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mv", "ts": 49, "dur": 3},
    ]
    tr = trace.reduce(ev)
    assert tr.window == (0.0, 100.0)
    assert [i.program for i in tr.intervals] == [True, False]
    assert tr.syncs_in_calls == 1
    assert tr.busy_us(0, 100) == 46.0
    assert tr.gaps(0, 100) == [(0.0, 14.0), (60.0, 100.0)]
    assert tr.host_doing(50) == "aten::mv"
    view = run.View(products=2, window_s=1e-4, setup_s=1.0, peak_bytes=1,
                    useful_flop=1.0, call_host_s=[0.1, 0.3],
                    product_s=[0.1, 0.3], counters={},
                    launches={}, kernel_work={"bsmm": (989e6 * 30, 1.0)},
                    peak={"flops": 989e12, "bytes_per_s": 3.35e12},
                    trace=tr)
    assert abs(view.roofline("bsmm") - 200.0) < 1e-9
    assert run.metric_reader("executor.aux_ms")(view) == 0.0
    assert abs(run.metric_reader("device.idle")(view) - 54.0) < 1e-9
    assert abs(run.metric_reader("api.call_host_ms")(view) - 200.0) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_program_passes_and_control_fails(small_cell, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell(name)
    cfg, traffic = {"n": 4096}, {"band_rows": 256, "k_blocks": 16}
    if name == "nu32k.dense":
        cfg.update(num_blocks=16, avg_block=256)
        traffic.update(tile=256, k_blocks=None)
    else:
        cfg.update(block=256)
    cell.config.update(cfg)
    cell.traffic.update(traffic)
    results = {}
    for kind, wrap in (("program", None), ("control", reference.control)):
        got = run.run_cell(cell, seed=7, seconds=1.0, trace=False, device="cuda",
                           t0=time.perf_counter(), wrap=wrap)
        results[kind] = run.result_line(cell, got, False)[0]
    assert results["program"]["correct"] is True
    assert results["control"]["correct"] is False
