"""The schedule layer: the port's ``repro_torch.sched`` against the
reference's ``repro.sched``.

Both are numpy over a ``MatmulPlan`` and must agree exactly: every task
(kind, step, devices, resource, FLOPs, bytes) and every edge of the task
graphs, the simulated makespans and summaries, the golden Chrome trace and
its fingerprint, the tuner's whole ``tuned`` record with the tuned plan's
fields, ``tune_chain``, ``ring_makespan`` and the CLI's JSON.  Plans are
built by each package's own planner from the same numpy structure, the
reference's over a ``FakeMesh``, the port's over a planning-only ``Grid``.
"""
import json

import numpy as np
import pytest
import torch

import repro.sched as ref_sched
from repro.core import sparsity as ref_sp
from repro.core.blocking import bucketize as ref_bucketize
from repro.core.blocking import nonuniform_tiling as ref_nonuniform_tiling
from repro.core.plan import plan_matmul as ref_plan_matmul
from repro.sched.__main__ import main as ref_main
from repro_torch import sched
from repro_torch.core import DistributedMatmul, Grid, plan_matmul
from repro_torch.core import sparsity as sp
from repro_torch.core.blocking import bucketize, nonuniform_tiling
from repro_torch.core.summa import execute_plan
from repro_torch.sched.__main__ import main as port_main
from repro_torch.spgemm import output_mask
from test_torch_plan import _cfgs, assert_plans_equal

GRIDS = [(2, 2), (4, 4), (3, 5)]
PLAN_FAMILIES = ["dense", "masked", "bsmm", "rank", "pull", "stationary_A",
                 "stationary_B"]
GOLDEN_TRACE = __file__.rsplit("/", 1)[0] + "/golden/sched_trace_small.json"


def _lcm(a, b):
    return a * b // int(np.gcd(a, b))


def _plan_pair(grid, family, n=480, blocks=8, **cfg_kw):
    """The same product planned by both packages (``n`` divides 3, 4, 5)."""
    local = "pallas" if family == "bsmm" else "xla"
    port_cfg, ref_cfg = _cfgs(*grid, local_matmul=local, **cfg_kw)
    kw = {}
    port_kw, ref_kw = {}, {}
    if family in ("masked", "bsmm", "pull", "stationary_A", "stationary_B"):
        a_mask = ref_sp.banded_block_mask(blocks, blocks, 1)
        b_mask = ref_sp.random_block_mask(blocks, blocks, 0.6, seed=2)
        kw = dict(a_mask=a_mask, b_mask=b_mask)
        if family == "pull":
            kw.update(comm_mode="pull", c_mask=output_mask(a_mask, b_mask))
        elif family.startswith("stationary"):
            kw["stationarity"] = family[-1]
    elif family == "rank":
        ranks = ref_sp.decay_rank_map(
            blocks, blocks, n // blocks, n // blocks, max_rank=6, decay=0.7,
            threshold=2e-2,
        ).ranks
        port_kw["a_ranks"] = sp.BlockRankMap(
            ranks=ranks, bm=n // blocks, bk=n // blocks)
        ref_kw["a_ranks"] = ref_sp.BlockRankMap(
            ranks=ranks, bm=n // blocks, bk=n // blocks)
        kw["b_mask"] = ref_sp.random_block_mask(blocks, blocks, 0.7, seed=3)
    port = plan_matmul(n, n, n, port_cfg, **kw, **port_kw)
    ref = ref_plan_matmul(n, n, n, ref_cfg, **kw, **ref_kw)
    return port, ref


def _graph_rows(graph):
    return (
        [(t.tid, t.kind, t.step, t.devices, t.resource, t.flops, t.bytes)
         for t in graph.tasks],
        list(graph.deps),
    )


def assert_graphs_equal(port, ref):
    assert (port.p_row, port.p_col, port.n_steps, port.lookahead) == (
        ref.p_row, ref.p_col, ref.n_steps, ref.lookahead)
    assert port.meta == ref.meta
    assert port.counts() == ref.counts()
    assert port.total_flops() == ref.total_flops()
    assert port.total_bytes() == ref.total_bytes()
    assert _graph_rows(port) == _graph_rows(ref)


@pytest.mark.parametrize("family", PLAN_FAMILIES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_from_plan_and_simulation_match_reference(grid, family):
    port, ref = _plan_pair(grid, family, k_blocks=_lcm(*grid) * 2)
    assert_plans_equal(port, ref)
    strategies = [None]
    if family == "dense":
        strategies += ["procedural", "allgather"]
    for strategy in strategies:
        pg = sched.from_plan(port, strategy=strategy)
        rg = ref_sched.from_plan(ref, strategy=strategy)
        assert_graphs_equal(pg, rg)
        ps, rs = sched.simulate(pg, trace=True), ref_sched.simulate(rg,
                                                                    trace=True)
        assert ps.summary() == rs.summary()
        assert ps.fingerprint() == rs.fingerprint()
        np.testing.assert_array_equal(ps.busy_comm_s, rs.busy_comm_s)
    assert (sched.simulate_plan(port, lookahead=1).summary()
            == ref_sched.simulate_plan(ref, lookahead=1).summary())


def _golden_graph(builders):
    tilings = [builders.nonuniform_tiling(64, 4, seed=7 + s) for s in range(3)]
    return builders.from_tilings(2, 2, *tilings, lookahead=2)


class _PortBuilders:
    nonuniform_tiling = staticmethod(nonuniform_tiling)
    from_tilings = staticmethod(sched.from_tilings)


def test_simulator_matches_golden_trace():
    """The reference's committed golden trace, reproduced bitwise."""
    with open(GOLDEN_TRACE) as f:
        golden = json.load(f)
    sim = sched.simulate(_golden_graph(_PortBuilders), trace=True)
    assert sim.fingerprint() == golden["fingerprint"]
    assert sim.makespan_s == golden["makespan_s"]
    assert sim.chrome_trace() == golden["trace"]
    again = sched.simulate(_golden_graph(_PortBuilders), trace=True)
    assert again.fingerprint() == sim.fingerprint()


@pytest.mark.parametrize("lookahead", [None, 1, 3])
@pytest.mark.parametrize("grid", [(2, 4), (4, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_from_tilings_and_chain_match_reference(grid, lookahead):
    port_t = [nonuniform_tiling(1024, 16, seed=1 + s) for s in range(3)]
    ref_t = [ref_nonuniform_tiling(1024, 16, seed=1 + s) for s in range(3)]
    pg = sched.from_tilings(*grid, *port_t, lookahead=lookahead)
    rg = ref_sched.from_tilings(*grid, *ref_t, lookahead=lookahead)
    assert_graphs_equal(pg, rg)
    assert (sched.simulate(pg).summary()
            == ref_sched.simulate(rg).summary())
    chained = sched.chain_graphs([pg, pg])
    ref_chained = ref_sched.chain_graphs([rg, rg])
    assert_graphs_equal(chained, ref_chained)
    assert (sched.eq1_lookahead(*grid, 16)
            == ref_sched.eq1_lookahead(*grid, 16))
    assert (sched.lookahead_candidates(*grid, 16)
            == ref_sched.lookahead_candidates(*grid, 16))


TUNE_CASES = [
    ((1, 1), "dense", False), ((2, 2), "dense", False),
    ((4, 4), "dense", True), ((2, 4), "masked", False),
    ((4, 4), "masked", True), ((2, 2), "bsmm", True), ((2, 2), "rank", False),
]


@pytest.mark.parametrize("grid,family,nonuniform", TUNE_CASES,
                         ids=lambda v: str(v))
def test_tune_plan_matches_reference(grid, family, nonuniform):
    """The whole ``tuned`` record and every field of the tuned plan; the
    nonuniform cases plan the bucketized extents of nonuniform tilings
    (what ``NonuniformMatmul.plan(tune=True)`` tunes)."""
    if nonuniform:
        tilings = [nonuniform_tiling(1024, 12, seed=s) for s in range(3)]
        n_rows, n_inner, n_cols = (bucketize(t, 64).padded_extent
                                   for t in tilings)
        assert [bucketize(t, 64).padded_extent for t in tilings] == [
            ref_bucketize(ref_nonuniform_tiling(1024, 12, seed=s),
                          64).padded_extent for s in range(3)]
    else:
        n_rows = n_inner = n_cols = 512
    port_cfg, ref_cfg = _cfgs(*grid, strategy="taskbased",
                              local_matmul="pallas" if family == "bsmm"
                              else "xla")
    kw = {}
    blocks = 8
    if family in ("masked", "bsmm"):
        kw = dict(
            a_mask=ref_sp.random_block_mask(blocks, blocks, 0.5, seed=1),
            b_mask=ref_sp.random_block_mask(blocks, blocks, 0.5, seed=2),
        )
    port_kw, ref_kw = dict(kw), dict(kw)
    if family == "rank":
        ranks = ref_sp.decay_rank_map(
            blocks, blocks, 64, 64, max_rank=8, decay=0.6, threshold=2e-2
        )
        port_kw["a_ranks"] = sp.BlockRankMap(ranks=ranks.ranks, bm=64, bk=64)
        ref_kw["a_ranks"] = ranks
        port_kw["rank_payload"] = ref_kw["rank_payload"] = True
    port = sched.tune_plan(plan_matmul(n_rows, n_inner, n_cols, port_cfg,
                                       **port_kw))
    ref = ref_sched.tune_plan(ref_plan_matmul(n_rows, n_inner, n_cols,
                                              ref_cfg, **ref_kw))
    assert port.tuned == ref.tuned
    assert port.cfg.strategy == ref.cfg.strategy
    assert port.cfg.k_blocks == ref.cfg.k_blocks
    assert_plans_equal(port, ref)
    assert port.tuned["makespan_s"] <= port.tuned["static_makespan_s"] * (
        1 + 1e-9)


def test_tuner_machines_ring_and_chain_match_reference():
    port_cfg, ref_cfg = _cfgs(4, 4, strategy="procedural")
    port = plan_matmul(1024, 1024, 1024, port_cfg)
    ref = ref_plan_matmul(1024, 1024, 1024, ref_cfg)
    for rates in ((1e15, 1e8), (1e9, 1e12)):
        pm = sched.MachineModel(*rates, name="m")
        rm = ref_sched.MachineModel(*rates, name="m")
        assert (sched.tune_plan(port, machine=pm).tuned
                == ref_sched.tune_plan(ref, machine=rm).tuned)
    assert sched.DEFAULT_MACHINE == sched.MachineModel(1e12, 5e10, 1e-6)
    for p_col in (1, 4, 8):
        pc, rc = _cfgs(1, p_col, strategy="taskbased")
        assert sched.ring_makespan(plan_matmul(512, 512, 512, pc)) == (
            ref_sched.ring_makespan(ref_plan_matmul(512, 512, 512, rc)))
    # the chain tuner: full search and its greedy fallback
    p_steps = [plan_matmul(256, 256, 256, _cfgs(2, 2, k_blocks=kb)[0])
               for kb in (4, 8)]
    r_steps = [ref_plan_matmul(256, 256, 256, _cfgs(2, 2, k_blocks=kb)[1])
               for kb in (4, 8)]
    for max_evals in (256, 1):
        p_las, p_sim, p_rec = sched.tune_chain(
            [lambda la, p=p: sched.from_plan(p, lookahead=la)
             for p in p_steps], max_evals=max_evals)
        r_las, r_sim, r_rec = ref_sched.tune_chain(
            [lambda la, p=p: ref_sched.from_plan(p, lookahead=la)
             for p in r_steps], max_evals=max_evals)
        assert (p_las, p_rec) == (r_las, r_rec)
        assert p_sim.makespan_s == r_sim.makespan_s


@pytest.mark.parametrize("argv", [
    ["--grid", "2", "2", "--extent", "256", "--blocks", "4", "--nonuniform",
     "--compare"],
    ["--grid", "4", "4", "--extent", "2048", "--blocks", "16",
     "--lookahead", "3"],
], ids=["nonuniform", "uniform"])
def test_cli_json_matches_reference(tmp_path, capsys, argv):
    outs = []
    for main, name in ((port_main, "port"), (ref_main, "ref")):
        trace, out = tmp_path / f"{name}.trace", tmp_path / f"{name}.json"
        main(argv + ["--trace", str(trace), "--json", str(out)])
        printed = capsys.readouterr().out
        outs.append((json.loads(out.read_text()),
                     json.loads(trace.read_text()), printed))
    (p_json, p_trace, p_out), (r_json, r_trace, r_out) = outs
    assert p_json == r_json and p_trace == r_trace
    assert p_out.replace("port", "ref") == r_out


def test_abstract_config_plans_but_never_executes():
    cfg = sched.abstract_summa_config(16, 16, strategy="taskbased")
    assert cfg.grid.shape == {"data": 16, "model": 16}
    plan = plan_matmul(512, 512, 512, cfg)
    with pytest.raises(ValueError, match="planning-only grid"):
        execute_plan(torch.ones(32, 32), torch.ones(32, 32), plan)
    mm = DistributedMatmul(Grid(sizes=(2, 2), device=torch.device("cpu")))
    with pytest.raises(ValueError, match="planning-only grid"):
        mm(np.ones((8, 8), np.float32), np.ones((8, 8), np.float32))
    # the reference's virtual config plans the same schedule
    ref = ref_plan_matmul(
        512, 512, 512, ref_sched.abstract_summa_config(16, 16,
                                                       strategy="taskbased"))
    assert_plans_equal(plan, ref)
