"""The continuous-batching front-end (``serve/scheduler.py``,
``serve/pages.py``, ``serve/plan_service.py``) against the JAX package.

The reference's ``init_model`` draws the weights (llama3.2-1b SMOKE,
fp32); they reach the port through ``models.convert.
params_from_reference``.  Both packages' schedulers serve the same
``ragged_trace`` (the port's trace equals the reference's request by
request), and every admission order, mode and backend must give the
reference scheduler's greedy tokens exactly — the reference's own
yardstick (``tests/test_scheduler.py``: batch rows are independent, so
the tokens are those of the serial per-request loop).  The page
allocator, the pool shapes and guards are host bookkeeping held as the
reference's tests hold them.  The plan service's keys, files and plans
equal the reference's on the 1x1 grid, and a file written by either
package loads in the other with the same winners.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.launch.mesh import make_mesh
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.serve import pages as ref_pages
from repro.serve import plan_service as ref_ps
from repro.serve import scheduler as ref_sched
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import engine, pages
from repro_torch.serve import plan_service as ps
from repro_torch.serve.scheduler import Scheduler, ragged_trace
from test_torch_plan import assert_plans_equal

CTX = ParallelCtx(None)
MAX_LEN = 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_plan_services(monkeypatch):
    """Both packages' plan-service singletons empty, and no cache file
    named by the environment, for each test."""
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    monkeypatch.delenv("REPRO_PLAN_SERVICE", raising=False)
    ps.set_plan_service(None)
    ref_ps.set_plan_service(None)
    yield
    ps.set_plan_service(None)
    ref_ps.set_plan_service(None)


def _cfgs():
    return (dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                                dtype="float32"),
            dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                                dtype="float32"))


def _trace(cfg, **kw):
    return ragged_trace(6, prompt_lens=(6, 10), gen_lens=(3, 8),
                        vocab=cfg.vocab_size, **kw)


@pytest.fixture(scope="module")
def served():
    """The port's continuous run and the reference scheduler's on the
    same trace."""
    cfg, rcfg = _cfgs()
    params = ref_model.init_model(jax.random.PRNGKey(0), rcfg, RefCtx(None))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    with torch.inference_mode():
        res = Scheduler(model, cfg, CTX, n_slots=2, max_len=MAX_LEN).run(
            _trace(cfg))
    ref = ref_sched.Scheduler(params, rcfg, RefCtx(None), n_slots=2,
                              max_len=MAX_LEN).run(
        ref_sched.ragged_trace(6, prompt_lens=(6, 10), gen_lens=(3, 8),
                               vocab=rcfg.vocab_size))
    return cfg, model, res, ref


def test_ragged_trace_matches_reference():
    for kw in ({}, dict(arrival_every=3, seed=4)):
        got = ragged_trace(7, prompt_lens=(5, 9, 2), gen_lens=(3, 8),
                           vocab=300, **kw)
        want = ref_sched.ragged_trace(7, prompt_lens=(5, 9, 2),
                                      gen_lens=(3, 8), vocab=300, **kw)
        for g, w in zip(got, want, strict=True):
            assert (g.rid, g.max_new_tokens, g.arrival_step) == (
                w.rid, w.max_new_tokens, w.arrival_step)
            np.testing.assert_array_equal(g.prompt, w.prompt)


def test_continuous_matches_reference_scheduler(served):
    _, _, res, ref = served
    assert res["outputs"] == ref["outputs"]
    assert res["steps"] == ref["steps"]
    assert res["prefills"] == ref["prefills"]
    assert res["generated_tokens"] == ref["generated_tokens"]
    assert res["p50_step_ms"] > 0 and res["p99_step_ms"] >= res["p50_step_ms"]


def test_continuous_matches_per_request_loop(served):
    """The reference's yardstick: each request alone through the port's
    engine, batch 1, prefill then greedy decode."""
    cfg, model, res, _ = served
    with torch.inference_mode():
        for r in _trace(cfg):
            logits, cache = engine.prefill(
                model, {"tokens": torch.from_numpy(
                    r.prompt.astype(np.int64))[None]}, cfg, CTX,
                max_len=MAX_LEN)
            toks = [int(logits[0].argmax())]
            for _ in range(r.max_new_tokens - 1):
                logits, cache = engine.decode_step(
                    model, cache, torch.tensor([toks[-1]]), cfg, CTX)
                toks.append(int(logits[0].argmax()))
            assert res["outputs"][r.rid] == toks, r.rid


def test_static_mode_same_outputs_more_steps(served):
    cfg, model, res, ref = served
    with torch.inference_mode():
        static = Scheduler(model, cfg, CTX, n_slots=2, max_len=MAX_LEN,
                           mode="static").run(_trace(cfg))
    assert static["outputs"] == ref["outputs"]
    assert static["steps"] > res["steps"], (static["steps"], res["steps"])


def test_paged_matches_dense(served):
    cfg, model, _, ref = served
    with torch.inference_mode():
        paged = Scheduler(
            model, cfg, CTX, n_slots=2, max_len=MAX_LEN, backend="paged",
            page_size=4,  # several on-demand page growths per request
        ).run(_trace(cfg))
    assert paged["outputs"] == ref["outputs"]
    assert paged["backend"] == "paged"


def test_admission_budget_defers_but_completes(served):
    cfg, model, _, ref = served
    with torch.inference_mode():
        tight = Scheduler(model, cfg, CTX, n_slots=2, max_len=MAX_LEN,
                          admit_budget_s=1e-12).run(_trace(cfg))
    assert tight["outputs"] == ref["outputs"]
    assert tight["budget_deferrals"] > 0


def test_staggered_arrivals(served):
    cfg, model, _, ref = served
    with torch.inference_mode():
        out = Scheduler(model, cfg, CTX, n_slots=2, max_len=MAX_LEN).run(
            _trace(cfg, arrival_every=3))
    assert out["outputs"] == ref["outputs"]  # arrival never changes content


def test_scheduler_raises_capacity_error(served):
    cfg, model, _, _ = served
    sched = Scheduler(model, cfg, CTX, n_slots=1, max_len=8)
    req = ragged_trace(1, prompt_lens=(6,), gen_lens=(5,))[0]  # 6 + 5 > 8
    with pytest.raises(engine.CacheCapacityError):
        sched.submit(req)


# ---------------------------------------------------------------------------
# page allocator (host-side unit tests, no model)
# ---------------------------------------------------------------------------


def test_page_allocator_alloc_release():
    a = pages.PageAllocator(n_pages=8, page_size=4, n_slots=2, max_pages=3)
    assert a.capacity == 12
    assert a.n_free() == 7  # page 0 reserved
    a.ensure(0, 5)  # 2 pages
    a.ensure(1, 4)  # 1 page
    assert a.n_free() == 4
    t = a.table().numpy()
    assert t.shape == (2, 3)
    assert (t[0, :2] > 0).all() and t[0, 2] == 0
    assert 0 not in a.slot_pages[0]  # trash page never allocated
    a.ensure(0, 5)  # idempotent
    assert a.n_free() == 4
    assert a.release(0) == 2
    assert a.n_free() == 6
    assert (a.table().numpy()[0] == 0).all()
    # the same bookkeeping as the reference's allocator, call by call
    r = ref_pages.PageAllocator(n_pages=8, page_size=4, n_slots=2,
                                      max_pages=3)
    r.ensure(0, 5)
    r.ensure(1, 4)
    r.release(0)
    assert r.free == a.free and r.slot_pages == a.slot_pages
    np.testing.assert_array_equal(np.asarray(r.table()), a.table().numpy())


def test_page_allocator_exhaustion_and_capacity():
    a = pages.PageAllocator(n_pages=4, page_size=2, n_slots=2, max_pages=4)
    a.ensure(0, 6)  # all 3 allocatable pages
    with pytest.raises(pages.OutOfPages):
        a.ensure(1, 1)
    assert a.slot_pages[1] == []  # failed ensure allocates nothing
    with pytest.raises(engine.CacheCapacityError):
        a.ensure(0, 9)  # 5 pages > max_pages


def test_paged_pool_shapes():
    cfg, rcfg = _cfgs()
    cache = pages.paged_init_cache(cfg, n_slots=2, n_pages=9, page_size=4,
                                   ctx=CTX, device="meta")
    want = jax.eval_shape(lambda: ref_pages.paged_init_cache(
        rcfg, n_slots=2, n_pages=9, page_size=4, ctx=RefCtx(None)))
    k = cache["units"]["b0"]["k"]
    assert k.shape == (cfg.units, 9, cfg.num_kv_heads, 4,
                       cfg.resolved_head_dim)
    assert tuple(want["units"]["b0"]["k"].shape) == tuple(k.shape)
    assert cache["pos"].shape == (2,)


def test_paged_guards():
    cfg, _ = _cfgs()
    with pytest.raises(NotImplementedError):
        pages.paged_init_cache(cfg, 2, 9, 4, ParallelCtx(None, kv_quant=True),
                               device="meta")
    wcfg = get_config("mixtral-8x7b", smoke=True)
    assert wcfg.window is not None
    with pytest.raises(NotImplementedError):
        pages.paged_init_cache(wcfg, 2, 9, 4, CTX, device="meta")
    with pytest.raises(NotImplementedError):
        pages.paged_init_cache(cfg, 2, 9, 4, ParallelCtx(Grid(sizes=(1, 2))),
                               device="meta")


def test_paged_pool_on_a_dp_grid_is_the_references():
    """A data-parallel grid is in the reference's scope: on dp = 2, tp = 1
    the pool keeps the reference's shape (the page axis whole) and the
    per-slot leaves take the rows they are given."""
    cfg, rcfg = _cfgs()
    ctx = ParallelCtx(Grid(sizes=(2, 1)))
    assert ctx.dp_size == 2 and ctx.tp_size == 1
    cache = pages.paged_init_cache(cfg, 1, 9, 4, ctx, device="meta")
    want = jax.eval_shape(lambda: ref_pages.paged_init_cache(
        rcfg, n_slots=2, n_pages=9, page_size=4, ctx=RefCtx(None)))
    for key in ("k", "v"):
        assert (tuple(cache["units"]["b0"][key].shape)
                == tuple(want["units"]["b0"][key].shape))
    assert cache["pos"].shape == (1,)


# ---------------------------------------------------------------------------
# persistent plan service
# ---------------------------------------------------------------------------


def _auto_ctxs():
    return (ParallelCtx(Grid.local("cpu"), matmul_strategy="auto"),
            RefCtx(mesh=make_mesh((1, 1), ("data", "model")),
                   matmul_strategy="auto"))


def test_warm_plans_match_reference():
    """Under "summa" and "auto" the warmed plans equal the reference's,
    shape by shape; the services record the same keys and winners, the
    grid fingerprint the mesh's; no grid, "xla" and pure DP warm
    nothing."""
    cfg, rcfg = _cfgs()
    for strategy in ("summa", "auto"):
        ctx = ParallelCtx(Grid.local("cpu"), matmul_strategy=strategy)
        rctx = RefCtx(mesh=make_mesh((1, 1), ("data", "model")),
                      matmul_strategy=strategy)
        svc, rsvc = ps.PlanService(), ref_ps.PlanService()
        got = engine.warm_matmul_plans(cfg, ctx, 2, 8, service=svc)
        want = ref_engine.warm_matmul_plans(rcfg, rctx, 2, 8,
                                            warm_executables=False,
                                            service=rsvc)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert_plans_equal(g, w)
        assert svc.table == rsvc.table and svc.traffic == rsvc.traffic
        assert svc.stats == rsvc.stats
        assert ps.mesh_fingerprint(ctx) == ref_ps.mesh_fingerprint(rctx)
    for ctx in (CTX, ParallelCtx(Grid.local("cpu")),
                ParallelCtx(Grid.local("cpu"), matmul_strategy="summa",
                            pure_dp=True)):
        assert engine.warm_matmul_plans(cfg, ctx, 2, 8) == []
    assert ps.mesh_fingerprint(CTX) == "nomesh"


def test_plan_service_roundtrip(tmp_path):
    """Cold warm-up tunes once per shape; a restored service re-applies
    the stored winners with zero tuner runs and a stable fingerprint."""
    cfg, _ = _cfgs()
    ctx, _ = _auto_ctxs()
    cold = ps.PlanService()
    plans = engine.warm_matmul_plans(cfg, ctx, 2, 8, warm_executables=False,
                                     service=cold)
    assert plans and cold.stats["tunes"] == len(cold.table) > 0
    assert cold.traffic == {"2x8": 1}
    path = os.fspath(tmp_path / "plans.json")
    cold.save(path)
    data = json.load(open(path))
    assert data["version"] == 1 and data["entries"]

    warm = ps.PlanService()
    assert warm.load(path) == len(cold.table)
    replans = engine.warm_matmul_plans(cfg, ctx, 2, 8,
                                       warm_executables=False, service=warm)
    assert warm.stats["tunes"] == 0
    assert warm.stats["hits"] == len(plans)
    assert warm.fingerprint() == cold.fingerprint() != ""
    for p, q in zip(plans, replans):
        assert q.cfg.strategy == p.tuned["strategy"]
        assert q.k_steps == p.tuned["k_blocks"]
        assert q.resolve_lookahead() == p.tuned["lookahead"]


def test_plan_service_keys_isolate_grid_and_shape():
    cfg, _ = _cfgs()
    ctx, _ = _auto_ctxs()
    svc = ps.PlanService()
    engine.warm_matmul_plans(cfg, ctx, 2, 8, warm_executables=False,
                             service=svc)
    n = len(svc.table)
    engine.warm_matmul_plans(cfg, ctx, 4, 8, warm_executables=False,
                             service=svc)  # new batch -> new decode shape
    assert len(svc.table) > n
    assert svc.top_traffic() == [(2, 8), (4, 8)]
    other = ParallelCtx(Grid.local("cpu", axis_names=("rows", "model")),
                        dp_axes=("rows",), matmul_strategy="auto")
    assert ps.mesh_fingerprint(other) != ps.mesh_fingerprint(ctx)


def test_plan_cache_env_seeds_the_singleton(tmp_path, monkeypatch):
    """A fresh process's singleton, seeded from ``REPRO_PLAN_CACHE``,
    re-applies the winners with zero tuner runs; ``REPRO_PLAN_SERVICE=0``
    disables consults."""
    cfg, _ = _cfgs()
    ctx, _ = _auto_ctxs()
    cold = ps.PlanService()
    engine.warm_matmul_plans(cfg, ctx, 2, 8, warm_executables=False,
                             service=cold)
    path = os.fspath(tmp_path / "plans.json")
    cold.save(path)
    monkeypatch.setenv("REPRO_PLAN_CACHE", path)
    ps.set_plan_service(None)
    svc = ps.plan_service()
    assert len(svc.table) == len(cold.table)
    engine.warm_matmul_plans(cfg, ctx, 2, 8, warm_executables=False)
    assert svc.stats["tunes"] == 0 and svc.stats["hits"] > 0
    monkeypatch.setenv("REPRO_PLAN_SERVICE", "0")
    assert svc.lookup(1, 2, 3, itemsize=4, structure="dense",
                      mesh_fp="nomesh") is None
    assert svc.fingerprint() == ""


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_file_loads_in_the_other_package(tmp_path, writer):
    """A file written by one package loads in either: the same table and
    fingerprint, every shape a hit with zero tunes, and the re-applied
    plans of the two packages equal."""
    cfg, rcfg = _cfgs()
    ctx, rctx = _auto_ctxs()
    path = os.fspath(tmp_path / "plans.json")
    if writer == "port":
        src = ps.PlanService()
        engine.warm_matmul_plans(cfg, ctx, 2, 8, warm_executables=False,
                                 service=src)
    else:
        src = ref_ps.PlanService()
        ref_engine.warm_matmul_plans(rcfg, rctx, 2, 8,
                                     warm_executables=False, service=src)
    src.save(path)
    port_svc, ref_svc = ps.PlanService(), ref_ps.PlanService()
    for svc in (port_svc, ref_svc):
        assert svc.load(path) == len(src.table)
        assert svc.table == src.table
        assert svc.fingerprint() == src.fingerprint() != ""
    got = engine.warm_matmul_plans(cfg, ctx, 2, 8, warm_executables=False,
                                   service=port_svc)
    want = ref_engine.warm_matmul_plans(rcfg, rctx, 2, 8,
                                        warm_executables=False,
                                        service=ref_svc)
    for svc in (port_svc, ref_svc):
        assert svc.stats["tunes"] == 0 and svc.stats["hits"] == len(want)
    for g, w in zip(got, want, strict=True):
        assert_plans_equal(g, w)
