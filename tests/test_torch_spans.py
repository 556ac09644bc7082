"""The span recorder (``repro_torch.analysis.spans``) and the per-layer
metrics of ``mmbench`` that read it.

On the CPU: each route of the entry point records one ``api.call`` root
with its child spans at the counts its plan gives; nothing is kept while
the recorder is off; under ``torch.profiler`` every span sits in the
exported trace inside the caller's range; ``bsmm``'s block counters equal
a count of the masks; and the benchmark's readers return numbers, or None
where they must.  One test, marked ``gpu``, holds a span's device time to
CUDA events taken outside the program (it skips without a card, decided
inside the test).  The file imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
import timeit

import numpy as np
import pytest
import torch

from repro_torch.analysis import spans
from repro_torch.core import DistributedMatmul, Grid, summa
from repro_torch.core.api import NonuniformMatmul
from repro_torch.core.blocking import Tiling
from repro_torch.core.sparsity import decay_rank_map, synthesize_rank_csr


@pytest.fixture(autouse=True)
def _clean():
    summa.clear_executable_cache()
    spans.clear()
    yield
    spans.clear()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(shape, seed):
    return torch.from_numpy(_rng(seed).standard_normal(shape,
                                                       dtype=np.float32))


def _masks(kb, nb, seed, fill=0.5):
    """An A mask (8, kb) and a B mask (kb, nb), every A row and B column
    with a live block, one B row dead."""
    rng = _rng(seed)
    a = rng.random((8, kb)) < fill
    b = rng.random((kb, nb)) < fill
    a[np.arange(8), rng.integers(0, kb, 8)] = True
    b[rng.integers(0, kb, nb), np.arange(nb)] = True
    b[kb - 1] = False
    return a, b


def _call(route):
    """One call of ``route`` through the entry point, on the CPU: the
    callable and what its spans must count."""
    if route == "dense":
        mm = DistributedMatmul(Grid.local("cpu"), k_blocks=4,
                               local_matmul="pallas")
        a, b = _normal((64, 128), 1), _normal((128, 96), 2)
        return (lambda: mm(a, b)), {"exec.accumulate": 4,
                                    "kernel.tiled_matmul": 4}
    if route == "bsmm":
        mm = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
        am, bm = _masks(8, 4, 3)
        a, b = _normal((64, 128), 4), _normal((128, 96), 5)
        return (lambda: mm(a, b, a_mask=am, b_mask=bm)), {
            "exec.mask": 2, "exec.panels": 1, "kernel.bsmm": 1}
    if route == "nonuniform":
        nm = NonuniformMatmul(
            DistributedMatmul(Grid.local("cpu"), local_matmul="pallas"),
            Tiling((20, 44, 36)), Tiling((30, 50, 48)), Tiling((40, 24, 32)),
            tile=32)
        a, b = _normal((100, 128), 6), _normal((128, 96), 7)
        return (lambda: nm(a, b)), {"blocking.expand": 4,
                                    "blocking.compact": 1}
    rk = synthesize_rank_csr(
        decay_rank_map(8, 4, 16, 32, max_rank=8, decay=0.8), seed=9)
    mm = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
    b = _normal((128, 64), 8)
    return (lambda: mm(None, b, a_ranks=rk)), {
        "rank.upload": 1, "kernel.grouped_gemm": 1, "rank.stage1": 1,
        "rank.stage2": 1}


ROUTES = ["dense", "bsmm", "nonuniform", "rank"]


@pytest.mark.parametrize("route", ROUTES)
def test_one_call_records_one_root_and_its_steps(route):
    call, want = _call(route)
    call()  # plans, builds and lays out once
    with spans.recording():
        call()
        recs = spans.records()
        summary = spans.summary()
    counts = {name: row["count"] for name, row in summary["spans"].items()}
    assert counts["api.call"] == 1
    for name, n in want.items():
        assert counts.get(name) == n, (name, counts)
    # a second call hits every cache: no build, no constants, no layout
    assert not {"plan.build", "exec.build", "exec.constants",
                "rank.layout"} & set(counts)
    assert counts["plan.lookup"] == counts["exec.dispatch"] == 1
    (root,) = [r for r in recs if r.name == spans.ROOT]
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.root == root.id
        assert r.device_s is None  # no device time on the CPU
        if r is not root:
            parent = by_id[r.parent]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    for name, row in summary["spans"].items():
        kids = sum(r.host_s for r in recs if r.parent is not None
                   and by_id[r.parent].name == name)
        assert row["self_host_s"] == pytest.approx(row["host_s"] - kids,
                                                   abs=1e-9)


def test_first_call_builds_and_a_nested_call_is_no_second_root():
    call, _ = _call("rank")
    with spans.recording():
        with spans.span(spans.ROOT):
            call()
        counts = {k: v["count"] for k, v in spans.summary()["spans"].items()}
    assert counts["api.call"] == 1
    assert {"plan.build", "exec.build", "exec.constants", "rank.layout"} <= \
        set(counts)


def test_nothing_is_kept_while_off():
    call, _ = _call("bsmm")
    call()
    null = spans.span("exec.mask")
    assert null is spans.span("api.call", device="cpu", operand="a")
    with null as inside:
        assert inside is None
    spans.count("bsmm.blocks_useful", 3)
    assert spans.records() == [] and spans.summary() == {"spans": {},
                                                         "counters": {}}
    with spans.recording():
        pass
    assert spans.records() == []
    # a span site costs well under a microsecond while off
    per_call = min(timeit.repeat(lambda: spans.span("exec.mask"),
                                 number=20000, repeat=5)) / 20000
    assert per_call < 2e-6


def test_spans_sit_in_the_profiler_trace(tmp_path):
    """Under ``torch.profiler`` the ambient session records, and every span
    is a ``user_annotation`` inside the caller's own range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    call, _ = _call("nonuniform")
    call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            call()
    recorded = spans.records()
    assert {r.name for r in recorded} >= {"api.call", "blocking.expand"}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    (caller,) = [e for e in notes if e["name"] == "caller"]
    lo, hi = caller["ts"], caller["ts"] + caller["dur"]
    inside = {}
    for e in notes:
        if e["name"] != "caller" and lo <= e["ts"] <= e["ts"] + e["dur"] <= hi:
            inside[e["name"]] = inside.get(e["name"], 0) + 1
    want = {}
    for r in recorded:
        want[r.name] = want.get(r.name, 0) + 1
    assert inside == want
    spans.clear()
    assert spans.records() == []


def _block_count(a_mask, b_mask, rows, cols, block):
    """Numpy's count of the block products of the rank owning A's block
    rows ``rows`` and C's block columns ``cols`` (B's mask blocks
    ``block`` columns wide), B's columns cut in the kernel's tiles of 256:
    ``(a_only, useful)``, the products over A's map alone (each live block
    of A whose panel meets the rank's B, times every tile) and those whose
    block of B under the tile is live."""
    a = a_mask[rows].astype(np.int64)
    g = math.gcd(256, block)
    b = np.repeat(b_mask[:, cols], block // g, axis=1)
    tiles = b.reshape(b.shape[0], -1, 256 // g).any(-1)
    a_only = int((a * tiles.any(1)).sum()) * tiles.shape[1]
    useful = int((a @ tiles.sum(1)).sum())
    return a_only, useful


@pytest.mark.parametrize("n, nb", [(1024, 4), (1024, 8), (2048, 4)])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_bsmm_block_counters_equal_a_count_of_the_masks(grid, n, nb):
    """``_bsmm_walk``'s count on each rank of a planning grid, and on the
    1x1 grid the counters a product adds, against numpy's count: the
    kernel's tiles of 256 columns span one, two or four blocks of B's
    mask.  B's mask kills some of A's products on every rank, so the
    kernel walks the map intersected with B's: it multiplies the useful
    products alone, fewer than A's map would have it multiply."""
    p_row, p_col = grid
    am, bm = _masks(8, nb, n + nb)
    mm = DistributedMatmul(Grid(sizes=grid, device="cpu"),
                           local_matmul="pallas")
    plan = mm.plan(64, 128, n, a_mask=am, b_mask=bm)
    assert plan.local_impl == "bsmm" and plan.local_block[1:] == (16, 256)
    n_loc, block = n // p_col, n // nb
    for i in range(p_row):
        for j in range(p_col):
            rows = slice(i * 8 // p_row, (i + 1) * 8 // p_row)
            cols = slice(j * nb // p_col, (j + 1) * nb // p_col)
            a_only, useful = _block_count(am, bm, rows, cols, block)
            walk, blocks = summa._bsmm_walk(plan, i, j, n_loc)
            assert blocks == (useful, useful) and useful < a_only
            assert walk.ndim == 3
    if grid != (1, 1):
        return
    mm = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
    a, b = _normal((64, 128), 1), _normal((128, n), 2)
    with spans.recording():
        mm(a, b, a_mask=am, b_mask=bm)
        mm(a, b, a_mask=am, b_mask=bm)
        counters = spans.summary()["counters"]
    a_only, useful = _block_count(am, bm, slice(None), slice(None), block)
    assert (counters["bsmm.blocks_multiplied"],
            counters["bsmm.blocks_useful"]) == (2 * useful, 2 * useful)
    assert useful < a_only


def _tile_map(plan, am, bm, i, j, n_loc, block):
    """Numpy's walk of the masks: rank ``(i, j)``'s list for each local
    block row and 256-column tile, the gathered panels (positions in
    ``plan.live_panels``) where A's block is live and some block of B's
    mask under the tile is; ``None`` where that keeps every entry of A's
    map (A's map alone is walked then)."""
    mb_loc = am.shape[0] // plan.p_row
    tiles = -(-n_loc // 256)
    lists, a_lists = {}, {}
    for ib in range(mb_loc):
        gb = i * mb_loc + ib
        a_lists[ib] = [pos for pos, kk in enumerate(plan.live_panels)
                       if am[gb, kk] and bm[kk, j * n_loc // block:
                                            (j + 1) * n_loc // block].any()]
        for t in range(tiles):
            lo = j * n_loc + 256 * t
            hi = min(lo + 256, (j + 1) * n_loc)
            under = bm[:, lo // block:-(-hi // block)]
            lists[ib, t] = [pos for pos in a_lists[ib]
                            if under[plan.live_panels[pos]].any()]
    if all(lists[ib, t] == a_lists[ib] for ib, t in lists):
        return None
    s = max(len(v) for v in lists.values())
    out = np.full((mb_loc, tiles, s), -1, np.int32)
    for (ib, t), v in lists.items():
        out[ib, t, :len(v)] = v
    return out


@pytest.mark.parametrize("n, nb", [(1024, 4), (1024, 8), (1024, 16),
                                   (2048, 4)])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_bsmm_tile_map_equals_a_walk_of_the_masks(grid, n, nb):
    """The intersected map ``_plan_constants`` uploads equals numpy's walk
    of the masks on every rank of a planning grid: B's mask blocks of 256,
    128, 64 and 512 columns, so a tile is skipped only when every block of
    B's mask under it is dead (128 and 64: finer than the tile)."""
    p_row, p_col = grid
    am, bm = _masks(8, nb, n + nb, fill=0.3)
    mm = DistributedMatmul(Grid(sizes=grid, device="cpu"),
                           local_matmul="pallas")
    plan = mm.plan(64, 128, n, a_mask=am, b_mask=bm)
    n_loc = n // p_col
    for i in range(p_row):
        for j in range(p_col):
            want = _tile_map(plan, am, bm, i, j, n_loc, n // nb)
            walk, _ = summa._bsmm_walk(plan, i, j, n_loc)
            if want is None:
                np.testing.assert_array_equal(walk, plan.local_cols[i, j])
            else:
                assert walk.dtype == np.int32 and walk.flags.c_contiguous
                np.testing.assert_array_equal(walk, want)
    if grid == (1, 1):
        consts = summa._plan_constants(plan, (64, 128), (128, n),
                                       torch.device("cpu"))
        assert consts["walk"].ndim == 3
        np.testing.assert_array_equal(consts["cols"].numpy(), consts["walk"])
        assert consts["cols"].dtype == torch.int32
        # counted once a plan: each listed entry by its tile's 256 columns
        assert consts["columns"] == 256.0 * int((consts["walk"] >= 0).sum())


@pytest.mark.parametrize("b_mask", ["none", "all_live"])
def test_bsmm_without_a_b_map_walks_a_map_alone(b_mask):
    """With no B mask, or an all-live one, the executor hands ``bsmm`` the
    plan's map of A alone, one list a block row, and C is the product of
    that map, bitwise: the walk the kernel took before B's map."""
    am, bm = _masks(8, 4, 3)
    b_mask = None if b_mask == "none" else np.ones_like(bm)
    mm = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
    a, b = _normal((64, 128), 4), _normal((128, 1024), 5)
    plan = mm.plan(64, 128, 1024, a_mask=am, b_mask=b_mask)
    consts = summa._plan_constants(plan, (64, 128), (128, 1024),
                                   torch.device("cpu"))
    assert consts["walk"] is not None and consts["walk"].ndim == 2
    np.testing.assert_array_equal(consts["walk"], plan.local_cols[0, 0])
    multiplied, useful = consts["blocks"]
    assert multiplied == useful == int((plan.local_cols >= 0).sum()) * 4
    assert consts["columns"] == int((plan.local_cols >= 0).sum()) * 1024.0
    got = mm(a, b, a_mask=am, b_mask=b_mask)
    a_m = summa._apply_block_mask(a, plan.a_mask, keep=consts["a"])
    b_m = summa._apply_block_mask(b, plan.b_mask, keep=consts["b"])
    want = summa._exec_sparse_bsmm(a_m, b_m, plan.local_cols[0, 0], plan,
                                   blocks=consts["blocks"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["u32k.bsp30", "u32k.dense", "nu32k.dense",
                                  "u32k.rank64"])
def test_benchmark_readers_on_a_small_traced_run(cell):
    """``run.run_cell(small(cell), trace=True)`` on the CPU: the readers of
    host time and counters give numbers, those of device time None, and
    every reader None when the session's calls are not the window's."""
    from mmbench import run
    from mmbench.metrics import reader
    from mmbench.tests.conftest import small

    c = small(run.resolve(run.load_benchmark(), cell))
    out = run.run_cell(c, seed=2**31 + 11, seconds=0.05, trace=True,
                       device="cpu", t0=time.perf_counter())
    view = out["view"]
    names = [m["name"] for m in c.per_layer
             if m["source"] in ("program_span", "program_counter")
             and m["name"] != "blocking.pad_flop_ratio"]
    assert names
    summary = spans.summary()
    assert summary["spans"]["api.call"]["count"] == view.products
    for name in names:
        value = reader(name)(view)
        if name.endswith("useful_share") or "host_ms" in name:
            assert value is not None and value > 0, name
        else:
            assert value is None, name
        assert reader(name)(dataclasses.replace(
            view, products=view.products + 1)) is None, name
    if cell == "u32k.bsp30":  # every B block of a small cell's tile is live
        assert reader("bsmm.useful_share")(view) == 100.0


def test_device_readers_take_device_time_per_product(monkeypatch):
    """With device times in the summary (as on the card), a reader gives
    their sum over its spans in ms per product."""
    from mmbench import spans as bench_spans
    from mmbench.metrics import reader

    fake = {"spans": {
        "api.call": {"count": 4, "host_s": 8.0, "self_host_s": 0.0,
                     "device_s": 8.0},
        "blocking.expand": {"count": 16, "host_s": 0.1, "self_host_s": 0.1,
                            "device_s": 0.12},
        "blocking.compact": {"count": 4, "host_s": 7.0, "self_host_s": 7.0,
                             "device_s": 0.04},
    }, "counters": {}}
    monkeypatch.setattr(bench_spans, "summary", lambda: fake)
    view = dataclasses.make_dataclass("V", ["products"])(4)
    assert reader("blocking.gather_ms.nonuniform")(view) == pytest.approx(40.0)
    assert reader("blocking.host_ms.nonuniform")(view) == pytest.approx(1775.0)
    assert reader("executor.mask_ms")(view) is None  # no such span


@pytest.mark.gpu
def test_span_device_time_matches_cuda_events_on_the_card():
    """A ``kernel.tiled_matmul`` span's device time is within 5 % of CUDA
    events around the same launch taken outside the program; nested
    device times never exceed their parent's; a dense product's kernel
    spans equal its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device time exists only on the card")
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul_cuda

    dev = torch.device("cuda")
    a = torch.randn(8192, 8192, device=dev)
    b = torch.randn(8192, 8192, device=dev)
    ops.tiled_matmul(a, b)  # builds the kernel
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        with spans.recording():
            torch.matmul(a, b)  # the card is busy when the events go in
            start.record()
            ops.tiled_matmul(a, b)
            end.record()
            (rec,) = spans.records()
            outside = start.elapsed_time(end) / 1e3
            assert rec.name == "kernel.tiled_matmul"
            assert rec.device_s == pytest.approx(outside, rel=0.05)
    mm = DistributedMatmul(Grid.local(dev), k_blocks=8, local_matmul="pallas")
    x, y = a[:4096, :4096], b[:4096, :4096]
    mm(x, y)
    before = tiled_matmul_cuda.launches
    with spans.recording():
        mm(x, y)
        recs = spans.records()
        counts = {k: v["count"] for k, v in spans.summary()["spans"].items()}
    assert counts["kernel.tiled_matmul"] == tiled_matmul_cuda.launches - before
    assert counts["exec.accumulate"] == 8
    by_id = {r.id: r for r in recs}
    for r in recs:
        parent = by_id.get(r.parent)
        while parent is not None and parent.device_s is None:
            parent = by_id.get(parent.parent)
        if r.device_s is not None and parent is not None:
            assert r.device_s <= parent.device_s * (1 + 1e-6), r.name
