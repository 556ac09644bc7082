"""The tensor front-end: the port's ``core.contract`` against the
reference's ``repro.core.contract``.

Structure must match exactly: spec parsing, merged tilings and their
orders, mask matricization, step geometry, inferred output masks, every
plan a contraction builds, ``contract_chain``'s report and the cache
counters after the same calls.  Values go through both packages from the
same seeded numpy operands (``conftest.contract_case``) and are held to
``ORACLE_ATOL``/``ORACLE_RTOL`` against the reference and the float64
einsum; the port's compiled step programs must equal its eager route
bitwise.  The reference runs on a 1x1 host mesh (its Pallas kernels in
interpret mode for ``local_matmul="pallas"``), the port on
``Grid.local("cpu")`` (the kernels' plain versions), and on a 2x2 grid of
gloo processes.
"""
import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (
    CONTRACT_SPECS,
    ORACLE_ATOL,
    ORACLE_RTOL,
    SRC,
    contract_case,
)
from repro.core import DistributedMatmul as RefDistributedMatmul
from repro.core import summa as ref_summa
from repro.core.blocking import nonuniform_tiling as ref_nonuniform_tiling
from repro.launch.mesh import make_host_mesh
from repro_torch.core import DistributedMatmul, Grid
from repro_torch.core import blocking as pbk
from repro_torch.core import summa as port_summa
from repro_torch.core.sparsity import BlockCSR, RankCSR
from repro_torch.kernels import autotune as at
from repro_torch.sched import chain_graphs, from_tilings, simulate

from test_torch_plan import assert_plans_equal  # noqa: E402

# the packages export a function ``contract``, which hides the module
ref_contract = importlib.import_module("repro.core.contract")
pc = importlib.import_module("repro_torch.core.contract")

GOLDEN_CHAIN_TRACE = os.path.join(
    os.path.dirname(__file__), "golden", "contract_chain_trace.json"
)


@pytest.fixture(autouse=True)
def _clean_caches():
    """One torch thread; both executable caches and the port's autotune
    cache start empty."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    at.set_autotune_cache(None)
    port_summa.clear_executable_cache()
    ref_summa.clear_executable_cache()
    yield
    torch.set_num_threads(prev)
    port_summa.clear_executable_cache()
    ref_summa.clear_executable_cache()


def to_port(t):
    """The port's twin of a reference ``BlockSparseTensor`` (same numpy)."""
    tilings = tuple(pbk.Tiling(tuple(tt.sizes)) for tt in t.tilings)
    if t.rank_csr is not None:
        r = t.rank_csr
        csr = BlockCSR(row_ptr=np.asarray(r.csr.row_ptr),
                       col_idx=np.asarray(r.csr.col_idx),
                       m_blocks=r.csr.m_blocks, n_blocks=r.csr.n_blocks)
        return pc.BlockSparseTensor(
            data=None, tilings=tilings,
            rank_csr=RankCSR(csr=csr, ranks=np.asarray(r.ranks),
                             u=np.asarray(r.u), v=np.asarray(r.v),
                             bm=r.bm, bk=r.bk))
    return pc.BlockSparseTensor(
        data=np.array(t.data), tilings=tilings, mask=t.mask, ranks=t.ranks,
        norms=t.norms)


def port_mm(compiled=True, local_matmul="xla", grid=None):
    return DistributedMatmul(grid or Grid.local("cpu"), strategy="taskbased",
                             compiled=compiled, local_matmul=local_matmul)


def ref_mm(compiled=True, local_matmul="xla"):
    return RefDistributedMatmul(make_host_mesh(1, 1), strategy="taskbased",
                                compiled=compiled, local_matmul=local_matmul)


def assert_plan_caches_equal(port, ref):
    """The two instances planned the same products: identical keys, equal
    plans."""
    assert set(port._plan_cache) == set(ref._plan_cache)
    for key, plan in port._plan_cache.items():
        assert_plans_equal(plan, ref._plan_cache[key])


def assert_tilings_equal(port_tilings, ref_tilings):
    assert [t.sizes for t in port_tilings] == [t.sizes for t in ref_tilings]


def _arr_eq(x, y):
    if x is None or y is None:
        assert x is None and y is None
    else:
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# structure: parsing, merging, matricization, geometry
# ---------------------------------------------------------------------------

SPECS = ["ab,bc->ac", "abc,cd->abd", "abc,bcd->ad", "ab,ca->cb",
         "sab,sbc->sac", "ijab,abcd->ijcd", "ab,ab->", "ab,bc", "ab->b",
         "aab,bc->ac", "ab,bc->acd", "abc,bd->ad", "ab,cd->abcd",
         "a1,1b->ab"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_contraction_matches_reference(spec):
    try:
        want = ref_contract.parse_contraction(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pc.parse_contraction(spec)
        assert str(got.value) == str(e)
        return
    got = pc.parse_contraction(spec)
    assert _spec_fields(got) == _spec_fields(want)
    assert got.spec == want.spec


def _spec_fields(spec):
    return {f: getattr(spec, f) for f in (
        "x_modes", "y_modes", "out_modes", "batch", "contracted", "free_x",
        "free_y")}


def _tilings(kind):
    """(port tilings, reference tilings) of one merge case."""
    sizes = {
        "one_mode": [(4, 4, 4)],
        "uniform": [(4,) * 3, (2,) * 5],
        "single_blocks": [(3, 3), (7,), (5,)],
        "nonuniform": [ref_nonuniform_tiling(20, 4, seed=1).sizes,
                       ref_nonuniform_tiling(15, 3, seed=2).sizes],
        "mixed": [(3, 3, 2), (4, 4), (2,) * 3],
        "ragged_uniform": [(4, 4, 1), (3, 3)],
    }[kind]
    from repro.core.blocking import Tiling as RefTiling

    return ([pbk.Tiling(tuple(s)) for s in sizes],
            [RefTiling(tuple(s)) for s in sizes])


@pytest.mark.parametrize("kind", ["one_mode", "uniform", "single_blocks",
                                  "nonuniform", "mixed", "ragged_uniform"])
def test_merge_tilings_matches_reference(kind):
    port_t, ref_t = _tilings(kind)
    got, got_perm = pc.merge_tilings(port_t)
    want, want_perm = ref_contract.merge_tilings(ref_t)
    assert got.sizes == want.sizes
    _arr_eq(got_perm, want_perm)
    # the split matricization and the gather by perm order alike
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=tuple(t.extent for t in port_t)
                                    + (3,)).astype(np.float32))
    merge = pc._Merge.of(tuple(port_t))
    rows = pc._to_matrix(x, merge, pc._Merge.of((pbk.Tiling((3,)),)))
    flat = x.reshape(-1, 3).numpy()
    want_rows = flat if want_perm is None else flat[want_perm]
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    back = pc._from_matrix(rows, merge, pc._Merge.of((pbk.Tiling((3,)),)),
                           tuple(x.shape))
    assert torch.equal(back, x)


@pytest.mark.parametrize("dtype", [bool, np.int32, np.float64])
def test_mask_matricize_round_trip_matches_reference(dtype):
    rng = np.random.default_rng(1)
    grid = (2, 3, 4, 5)
    arr = (rng.random(grid) < 0.5) if dtype is bool else (
        rng.integers(0, 9, grid).astype(dtype))
    modes = tuple("abcd")
    grids = dict(zip(modes, grid))
    for rows, cols, out in ((("a", "c"), ("b", "d"), "abcd"),
                            (("d",), ("b", "a", "c"), "cadb"),
                            ((), ("a", "b", "c", "d"), "abcd")):
        got = pc.matricize_mask(arr, modes, rows, cols)
        want = ref_contract.matricize_mask(arr, modes, rows, cols)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        back = pc.unmatricize_mask(got, rows, cols, grids, tuple(out))
        np.testing.assert_array_equal(back, ref_contract.unmatricize_mask(
            want, rows, cols, grids, tuple(out)))
        np.testing.assert_array_equal(
            back, np.transpose(arr, ["abcd".index(m) for m in out]))
    tilings = (pbk.Tiling((2, 3)), pbk.Tiling((1, 1, 2)),
               pbk.Tiling((4,) * 4), pbk.Tiling((1,) * 5))
    fine = pc.expand_block_mask(arr, tilings)
    np.testing.assert_array_equal(fine, ref_contract.expand_block_mask(
        arr, tuple(_tilings_ref(tilings))))
    np.testing.assert_array_equal(
        pc._expand_block_mask_on(arr, tilings, "cpu").numpy(),
        fine.astype(bool))


def _tilings_ref(tilings):
    from repro.core.blocking import Tiling as RefTiling

    return [RefTiling(t.sizes) for t in tilings]


def _assert_geom_equal(got, want):
    for og, ow in ((got.x_geom, want.x_geom), (got.y_geom, want.y_geom)):
        assert og.axes == ow.axes
        assert (og.row_modes, og.col_modes) == (ow.row_modes, ow.col_modes)
        assert og.row_tiling.sizes == ow.row_tiling.sizes
        assert og.col_tiling.sizes == ow.col_tiling.sizes
        _arr_eq(og.row_perm, ow.row_perm)
        _arr_eq(og.col_perm, ow.col_perm)
        assert og.identity == ow.identity
    for f in ("a_mask2", "b_mask2", "out_mask", "c_mask2",
              "out_row_perm_inv", "out_col_perm_inv"):
        _arr_eq(getattr(got, f), getattr(want, f))
    if hasattr(want.a_ranks2, "ranks"):
        _arr_eq(got.a_ranks2.ranks, want.a_ranks2.ranks)
        assert (got.a_ranks2.bm, got.a_ranks2.bk) == (
            want.a_ranks2.bm, want.a_ranks2.bk)
    else:
        _arr_eq(got.a_ranks2, want.a_ranks2)
    assert got.uniform == want.uniform and got.tile == want.tile
    assert_tilings_equal(got.out_tilings, want.out_tilings)
    assert got.cache_key == want.cache_key


@pytest.mark.parametrize("family", CONTRACT_SPECS)
def test_step_geometry_matches_reference(family):
    case = contract_case(family, seed=2)
    x, y = to_port(case["x"]), to_port(case["y"])
    if family == "batch":
        with pytest.raises(ValueError, match="batch modes"):
            pc._step_geometry(pc.parse_contraction(case["spec"]), x, y, 64)
        return
    got = pc._geometry_cached(port_mm(), case["spec"], x, y, case["tile"])
    want = ref_contract._geometry_cached(
        ref_mm(), case["spec"], case["x"], case["y"], case["tile"])
    _assert_geom_equal(got, want)


# ---------------------------------------------------------------------------
# the seven families through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("family", CONTRACT_SPECS)
def test_contract_families_match_reference_1x1(family, local_matmul):
    """Values against the reference and the float64 einsum, inferred
    masks and tilings, every plan, compiled against eager bitwise, and the
    cache counters after two identical calls."""
    case = contract_case(family, seed=5)
    x, y = to_port(case["x"]), to_port(case["y"])
    kw = dict(tile=case["tile"])
    ref = ref_mm(local_matmul=local_matmul)
    want = [ref.contract(case["spec"], case["x"], case["y"], **kw)
            for _ in range(2)][-1]
    mm = port_mm(local_matmul=local_matmul)
    got = [mm.contract(case["spec"], x, y, **kw) for _ in range(2)][-1]
    assert got.data.device.type == "cpu"
    np.testing.assert_allclose(got.data.numpy(), case["ref"],
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    _arr_eq(got.mask, want.mask)
    assert_tilings_equal(got.tilings, want.tilings)
    assert_plan_caches_equal(mm, ref)
    stats = mm.cache_stats()
    assert stats == ref.cache_stats()
    assert stats["contract"]["step_hits"] >= 1
    c = stats["contract"]
    assert c["step_retraces"] == c["step_misses"]
    eager = port_mm(compiled=False, local_matmul=local_matmul).contract(
        case["spec"], x, y, **kw)
    assert torch.equal(got.data, eager.data)
    _arr_eq(eager.mask, got.mask)


@pytest.mark.parametrize("family", ["matmul", "free2", "transpose"])
def test_filter_eps_matches_reference(family):
    """Norm screening: the filtered result against the reference's, within
    the plan's recorded bound of the exact contraction; the filtered mask
    and the propagated norm bounds."""
    case = contract_case(family, seed=4)
    x, y = to_port(case["x"]), to_port(case["y"])
    xn, yn = case["x"].block_norms(), case["y"].block_norms()
    eps = float(np.median(np.outer(xn[xn > 0], yn[yn > 0])))  # screens some
    ref, mm = ref_mm(), port_mm()
    want = ref.contract(case["spec"], case["x"], case["y"], filter_eps=eps)
    got = mm.contract(case["spec"], x, y, filter_eps=eps)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    _arr_eq(got.mask, want.mask)
    np.testing.assert_allclose(got.norms, want.norms, rtol=1e-12)
    (plan,) = mm._plan_cache.values()
    (ref_plan,) = ref._plan_cache.values()
    assert plan.filter_bound == pytest.approx(ref_plan.filter_bound,
                                              rel=1e-12)
    assert plan.filter_bound > 0
    err = np.linalg.norm(got.data.numpy().astype(np.float64) - case["ref"])
    assert err <= plan.filter_bound * (1 + 1e-5) + ORACLE_ATOL
    np.testing.assert_allclose(x.block_norms(), case["x"].block_norms(),
                               rtol=1e-12)
    eager = port_mm(compiled=False).contract(case["spec"], x, y,
                                             filter_eps=eps)
    assert torch.equal(got.data, eager.data)


def test_tensor_container_matches_reference():
    case = contract_case("nonuniform", seed=1)
    x = to_port(case["x"])
    assert x.fill() == case["x"].fill()
    assert x.block_grid == case["x"].block_grid
    np.testing.assert_array_equal(x.to_dense(), case["x"].to_dense())
    np.testing.assert_allclose(x.block_norms(), case["x"].block_norms(),
                               rtol=1e-12)
    r = to_port(contract_case("rank_sparse", seed=1)["x"])
    r_ref = contract_case("rank_sparse", seed=1)["x"]
    np.testing.assert_array_equal(r.block_mask, r_ref.block_mask)
    np.testing.assert_allclose(r.block_norms(), r_ref.block_norms(),
                               rtol=1e-12)
    np.testing.assert_array_equal(r.to_dense(), r_ref.to_dense())
    bf = pc.BlockSparseTensor.from_dense(torch.ones(4, 6, dtype=torch.bfloat16),
                                         block_shape=(2, 3))
    assert bf.to_dense().dtype == np.float32
    for bad, match in (
            (dict(data=np.zeros((4, 5)), tilings=((2, 2), (4,))), "extents"),
            (dict(data=None, tilings=((4,),)), "rank_csr"),
            (dict(data=np.zeros(4), tilings=((2, 2),), mask=np.ones(3, bool)),
             "block grid"),
            (dict(data=np.zeros(4), tilings=((2, 2),), mask=np.ones(2, bool),
                  ranks=np.ones(2)), "either mask or ranks")):
        with pytest.raises(ValueError, match=match):
            pc.BlockSparseTensor(**bad)


def test_front_end_edge_cases_match_reference():
    """A full contraction to a scalar, a raw array adopting its masked
    partner's blocking, and the refusals of the factor operand."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(12, 8)).astype(np.float32)
    b = rng.normal(size=(12, 8)).astype(np.float32)
    out = port_mm().contract("ab,ab->", a, b)
    assert out.ndim == 0 and out.data.shape == ()
    want = ref_mm().contract("ab,ab->", jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(out.data), float(want.data), rtol=1e-6)

    xm = rng.random((4, 2)) < 0.6
    xd = rng.normal(size=(16, 12)).astype(np.float32)
    raw = rng.normal(size=(12, 5)).astype(np.float32)
    x = pc.BlockSparseTensor.from_dense(xd, block_shape=(4, 6), mask=xm)
    ref_x = ref_contract.BlockSparseTensor.from_dense(
        jnp.asarray(xd), block_shape=(4, 6), mask=xm)
    got = port_mm().contract("ab,bc->ac", x, raw)
    want = ref_mm().contract("ab,bc->ac", ref_x, jnp.asarray(raw))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    _arr_eq(got.mask, want.mask)
    assert_tilings_equal(got.tilings, want.tilings)

    rank = to_port(contract_case("rank_sparse", seed=0)["x"])
    y = pc.BlockSparseTensor.from_dense(np.zeros((40, 64), np.float32),
                                        block_shape=(20, 16))
    with pytest.raises(NotImplementedError, match="densify"):
        port_mm().contract("ab,ca->cb", rank, y)
    with pytest.raises(NotImplementedError, match="first operand only"):
        port_mm().contract("ab,bc->ac", y, rank)
    with pytest.raises(NotImplementedError, match="batch modes"):
        port_mm().contract("sab,sbc->sac", np.zeros((2, 3, 4), np.float32),
                           np.zeros((2, 4, 5), np.float32), filter_eps=0.1)


def test_batch_mode_mismatch_raises():
    rng = np.random.default_rng(8)
    x = pc.BlockSparseTensor.from_dense(
        rng.normal(size=(4, 8, 8)).astype(np.float32),
        block_shape=(2, 4, 4), mask=rng.random((2, 2, 2)) < 0.7)
    with pytest.raises(ValueError, match="extents disagree"):
        port_mm().contract("sab,sbc->sac", x, pc.BlockSparseTensor.from_dense(
            np.zeros((2, 8, 8), np.float32), block_shape=(2, 4, 4)))
    with pytest.raises(ValueError, match="block batch modes"):
        port_mm().contract("sab,sbc->sac", x, pc.BlockSparseTensor.from_dense(
            np.zeros((4, 8, 8), np.float32), block_shape=(1, 4, 4),
            mask=np.ones((4, 2, 2), bool)))
    y_plain = rng.normal(size=(4, 8, 8)).astype(np.float32)
    out = port_mm().contract("sab,sbc->sac", x, pc.BlockSparseTensor.from_dense(
        y_plain, block_shape=(1, 4, 4)))
    np.testing.assert_allclose(
        out.data.numpy(),
        np.einsum("sab,sbc->sac", x.to_dense().astype(np.float64), y_plain),
        atol=ORACLE_ATOL, rtol=ORACLE_RTOL)


def test_grid_without_device_never_contracts_on_the_cpu():
    """Operands move to the grid's device: with no card the move raises."""
    mm = DistributedMatmul(Grid.local(), local_matmul="pallas")
    a = np.ones((8, 8), np.float32)
    if torch.cuda.is_available():
        assert mm.contract("ab,bc->ac", a, a).data.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            mm.contract("ab,bc->ac", a, a)


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------


def _chain_operands(seed=5):
    """contract_chain's end-to-end case of the reference's tests."""
    from repro.core import decay_block_mask

    rng = np.random.default_rng(seed)
    am = decay_block_mask(4, 4, decay=0.6, threshold=5e-2)
    xd = rng.normal(size=(64, 64)).astype(np.float32)
    y1 = rng.normal(size=(64, 64)).astype(np.float32)
    y2 = rng.normal(size=(64, 48)).astype(np.float32)
    ref = [ref_contract.BlockSparseTensor.from_dense(
        jnp.asarray(xd), block_shape=(16, 16), mask=am),
        ref_contract.BlockSparseTensor.from_dense(
            jnp.asarray(y1), block_shape=(16, 16), mask=am),
        ref_contract.BlockSparseTensor.from_dense(
            jnp.asarray(y2), block_shape=(16, 12))]
    return ref, [to_port(t) for t in ref]


@pytest.mark.parametrize("filter_eps", [0.0, 20.0])
@pytest.mark.parametrize("tune", [False, True])
def test_contract_chain_matches_reference(tune, filter_eps):
    """The report (makespans, windows, plan summaries, the traced
    simulation), the result and the cache counters."""
    ref_ops, ops = _chain_operands()
    specs = ("ab,bc->ac", "ab,bc->ac")
    kw = dict(tune=tune, trace=True, filter_eps=filter_eps)
    ref = ref_mm()
    want, want_rep = ref.contract_chain(
        [(specs[0], ref_ops[0], ref_ops[1]), (specs[1], ref_ops[2])], **kw)
    mm = port_mm()
    got, rep = mm.contract_chain(
        [(specs[0], ops[0], ops[1]), (specs[1], ops[2])], **kw)
    sim, want_sim = rep.pop("sim"), want_rep.pop("sim")
    assert sim.fingerprint() == want_sim.fingerprint()
    if filter_eps:
        bounds, want_bounds = (rep.pop("filter_bounds"),
                               want_rep.pop("filter_bounds"))
        np.testing.assert_allclose(bounds, want_bounds, rtol=1e-12)
        for p, w in zip(rep.pop("plans"), want_rep.pop("plans")):
            assert p.pop("filter_bound") == pytest.approx(
                w.pop("filter_bound"), rel=1e-12)
            assert p == w
    assert rep == want_rep
    assert rep["joint_makespan_s"] <= rep["sequential_makespan_s"]
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    _arr_eq(got.mask, want.mask)
    if not filter_eps:
        exact = (ref_ops[0].to_dense().astype(np.float64)
                 @ ref_ops[1].to_dense()) @ np.asarray(ref_ops[2].data)
        np.testing.assert_allclose(got.data.numpy(), exact,
                                   atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
        assert_plan_caches_equal(mm, ref)
    assert mm.cache_stats() == ref.cache_stats()
    eager, eager_rep = port_mm(compiled=False).contract_chain(
        [(specs[0], ops[0], ops[1]), (specs[1], ops[2])], **kw)
    assert torch.equal(got.data, eager.data)
    assert eager_rep["lookaheads"] == rep["lookaheads"]


def test_chain_matches_golden_trace():
    """The committed chain trace: D = (A.B).C over nonuniform blocks on a
    2x2 grid (the reference's ``_chain_golden_graphs``)."""
    t = [pbk.nonuniform_tiling(256, 8, seed=s) for s in (1, 2, 3, 4)]
    graphs = [from_tilings(2, 2, t[0], t[1], t[2]),
              from_tilings(2, 2, t[0], t[2], t[3])]
    with open(GOLDEN_CHAIN_TRACE) as f:
        golden = json.load(f)
    sim = simulate(chain_graphs(graphs), trace=True)
    assert sim.fingerprint() == golden["fingerprint"]
    assert sim.makespan_s == golden["makespan_s"]
    seq = sum(simulate(g).makespan_s for g in graphs)
    assert golden["joint_makespan_s"] <= golden["sequential_makespan_s"]
    assert sim.makespan_s <= seq * (1 + 1e-12)


# ---------------------------------------------------------------------------
# cache counters: the same sequence of calls through both packages
# ---------------------------------------------------------------------------


def test_cache_stats_follow_the_reference_call_by_call():
    """Products, contractions of every route, a repeated batch, a chain
    and a warmed plan: after each call both instances' ``cache_stats()``
    are equal section by section, and builds never exceed misses."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 48)).astype(np.float32)
    b = rng.normal(size=(48, 16)).astype(np.float32)
    mask_a = rng.random((4, 4)) < 0.6
    mask_b = rng.random((4, 2)) < 0.7
    cases = {f: contract_case(f, seed=3) for f in CONTRACT_SPECS}
    ref_ops, ops = _chain_operands(seed=1)
    mm, ref = port_mm(local_matmul="pallas"), ref_mm(local_matmul="pallas")

    def both(port_call, ref_call):
        port_call(mm)
        ref_call(ref)
        got, want = mm.cache_stats(), ref.cache_stats()
        assert got == want
        for s in (got["executable"], {
                "retraces": got["contract"]["step_retraces"],
                "misses": got["contract"]["step_misses"]}):
            assert s["retraces"] <= s["misses"]

    for _ in range(2):
        both(lambda m: m(a, b), lambda m: m(jnp.asarray(a), jnp.asarray(b)))
        both(lambda m: m(a, b, a_mask=mask_a, b_mask=mask_b),
             lambda m: m(jnp.asarray(a), jnp.asarray(b), a_mask=mask_a,
                         b_mask=mask_b))
    for family, case in cases.items():
        x, y = to_port(case["x"]), to_port(case["y"])
        for _ in range(2):
            both(lambda m: m.contract(case["spec"], x, y, tile=case["tile"]),
                 lambda m: m.contract(case["spec"], case["x"], case["y"],
                                      tile=case["tile"]))
    for _ in range(2):
        both(lambda m: m.contract_chain(
            [("ab,bc->ac", ops[0], ops[1]), ("ab,bc->ac", ops[2])],
            tune=True),
             lambda m: m.contract_chain(
            [("ab,bc->ac", ref_ops[0], ref_ops[1]),
             ("ab,bc->ac", ref_ops[2])], tune=True))
    plan, ref_plan = mm.plan(32, 48, 16), ref.plan(32, 48, 16)
    assert port_summa.warm_plan_executable(plan, torch.float32) == (
        ref_summa.warm_plan_executable(ref_plan, jnp.float32))
    assert mm.cache_stats() == ref.cache_stats()
    assert mm.cache_stats()["executable"]["hits"] > 0


def test_autotune_fingerprint_joins_the_step_key():
    """A non-empty autotune cache keys new step programs; emptying it
    finds the old ones again."""
    case = contract_case("matmul", seed=0)
    x, y = to_port(case["x"]), to_port(case["y"])
    mm = port_mm()
    mm.contract(case["spec"], x, y)
    assert port_summa._autotune_key_suffix() == ()
    table = at.KernelAutotuner(device_kind="cpu")
    table.table[at.bucket_key(128, 128, 128)] = {
        "winner": "xla", "times_s": {"xla": 1e-5, "pallas": 2e-5},
        "tiles": None}
    at.set_autotune_cache(table)
    assert port_summa._autotune_key_suffix() == (table.fingerprint(),)
    mm.contract(case["spec"], x, y)
    at.set_autotune_cache(None)
    mm.contract(case["spec"], x, y)
    c = mm.cache_stats()["contract"]
    assert (c["step_misses"], c["step_hits"]) == (2, 1)


# ---------------------------------------------------------------------------
# 2x2 grid of gloo processes: every family in one spawn
# ---------------------------------------------------------------------------

_GLOO_PROGRAM = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import DistributedMatmul, Grid
from repro_torch.core.blocking import Tiling
from repro_torch.core.contract import BlockSparseTensor
from repro_torch.core.sparsity import BlockCSR, RankCSR

rank, rdv, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
grid = Grid.from_process_group(2, 2, device="cpu")
case = np.load(data, allow_pickle=True)
families = list(case["families"])
out = {}


def operand(prefix):
    tilings = tuple(Tiling(tuple(s)) for s in case[prefix + "tilings"])
    if prefix + "u" in case.files:
        csr = BlockCSR(row_ptr=case[prefix + "row_ptr"],
                       col_idx=case[prefix + "col_idx"],
                       m_blocks=int(case[prefix + "mb"]),
                       n_blocks=int(case[prefix + "nb"]))
        rc = RankCSR(csr=csr, ranks=case[prefix + "ranks"],
                     u=case[prefix + "u"], v=case[prefix + "v"],
                     bm=int(case[prefix + "bm"]), bk=int(case[prefix + "bk"]))
        return BlockSparseTensor(data=None, tilings=tilings, rank_csr=rc)
    mask = case[prefix + "mask"] if prefix + "mask" in case.files else None
    return BlockSparseTensor(data=case[prefix + "data"], tilings=tilings,
                             mask=mask)


for f in families:
    for compiled in (True, False):
        mm = DistributedMatmul(grid, strategy="taskbased", compiled=compiled)
        res = mm.contract(str(case[f + ":spec"]), operand(f + ":x:"),
                          operand(f + ":y:"), tile=int(case[f + ":tile"]))
        out[f"{f}:{compiled}"] = res.data.numpy()
if rank == 0:
    np.savez(data.replace("case", "out"), **out)
dist.destroy_process_group()
"""


def _save_operand(arrays, prefix, t):
    arrays[prefix + "tilings"] = np.array(
        [np.asarray(tt.sizes) for tt in t.tilings], dtype=object)
    if t.rank_csr is not None:
        r = t.rank_csr
        arrays.update({prefix + "row_ptr": r.csr.row_ptr,
                       prefix + "col_idx": r.csr.col_idx,
                       prefix + "mb": r.csr.m_blocks,
                       prefix + "nb": r.csr.n_blocks,
                       prefix + "ranks": r.ranks, prefix + "u": r.u,
                       prefix + "v": r.v, prefix + "bm": r.bm,
                       prefix + "bk": r.bk})
        return
    arrays[prefix + "data"] = np.asarray(t.data)
    if t.mask is not None:
        arrays[prefix + "mask"] = t.mask


def test_2x2_gloo_grid_contracts_every_family(tmp_path):
    """Four gloo processes form the 2x2 grid: every family, compiled and
    eager, against the float64 einsum; compiled equals eager bitwise."""
    cases = {f: contract_case(f, seed=11) for f in CONTRACT_SPECS}
    arrays = {"families": np.array(list(cases))}
    for f, case in cases.items():
        arrays[f + ":spec"] = case["spec"]
        arrays[f + ":tile"] = case["tile"]
        _save_operand(arrays, f + ":x:", case["x"])
        _save_operand(arrays, f + ":y:", case["y"])
    data = tmp_path / "case.npz"
    np.savez(data, **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _GLOO_PROGRAM, str(rank),
             str(tmp_path / "rdv"), str(data)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(4)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    out = np.load(tmp_path / "out.npz")
    for f, case in cases.items():
        np.testing.assert_allclose(out[f"{f}:True"], case["ref"],
                                   atol=ORACLE_ATOL, rtol=ORACLE_RTOL,
                                   err_msg=f)
        np.testing.assert_array_equal(out[f"{f}:True"], out[f"{f}:False"],
                                      err_msg=f)
