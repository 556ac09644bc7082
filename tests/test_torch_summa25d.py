"""The rest of the paper's engine: grids of any number of axes, tuple row
and column axes, the executors' ``k_steps``/``k_start`` and 2.5D SUMMA,
against the JAX package, in process.

Plans over three-axis planning-only grids must equal the reference's
over a ``FakeMesh`` of the same axes, field by field.  Products run on
the one-rank grids of the CPU (1x1 and 1x1x1) and are held against the
reference's on meshes of the same axes with ``ORACLE_ATOL`` /
``ORACLE_RTOL``; the multi-rank runs are ``tests/test_torch_grid8.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ORACLE_ATOL, ORACLE_RTOL
from repro.core import summa as ref_summa
from repro.core.plan import plan_matmul as ref_plan_matmul
from repro.launch.mesh import make_mesh
from repro_torch.core import Grid, SummaConfig, plan_matmul
from repro_torch.core import summa
from repro_torch.core.sparsity import BlockRankMap

from test_torch_plan import (  # noqa: E402
    FAMILIES,
    K,
    M,
    N,
    FakeMesh,
    _plan_kwargs,
    assert_plans_equal,
)

AXES3 = ("pod", "data", "model")
#: (row_axis, col_axis) layouts of a (2, 2, 2) grid: the 2.5D one (pod
#: left to replicas), tuple rows, tuple columns
LAYOUTS = [("data", "model"), (("pod", "data"), "model"),
           ("data", ("model", "pod"))]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def clean_executables():
    summa.clear_executable_cache()
    ref_summa.clear_executable_cache()
    yield
    summa.clear_executable_cache()
    ref_summa.clear_executable_cache()


def _cfg_pair(sizes, row_axis, col_axis, **kw):
    port = SummaConfig(grid=Grid(sizes=sizes, axis_names=AXES3),
                       row_axis=row_axis, col_axis=col_axis, **kw)
    ref = ref_summa.SummaConfig(mesh=FakeMesh(dict(zip(AXES3, sizes))),
                                row_axis=row_axis, col_axis=col_axis, **kw)
    return port, ref


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
@pytest.mark.parametrize("family", FAMILIES)
def test_three_axis_plans_match_reference(family, layout):
    """Plans on a (2, 2, 2) planning-only grid equal the reference's on a
    (2, 2, 2) mesh, with single and tuple row and column axes."""
    row_axis, col_axis = LAYOUTS[layout]
    port_cfg, ref_cfg = _cfg_pair((2, 2, 2), row_axis, col_axis,
                                  strategy="taskbased")
    assert (port_cfg.p_row, port_cfg.p_col) == (ref_cfg.p_row, ref_cfg.p_col)
    kw = _plan_kwargs(family, "plain", rank_cls=BlockRankMap)
    from repro.core.sparsity import BlockRankMap as RefBlockRankMap

    ref_kw = _plan_kwargs(family, "plain", rank_cls=RefBlockRankMap)
    port = plan_matmul(M, K, N, port_cfg, **kw)
    ref = ref_plan_matmul(M, K, N, ref_cfg, **ref_kw)
    assert_plans_equal(port, ref)


def test_three_axis_grid_geometry():
    """Tuple axes index as a mesh orders them (the first name most
    significant); ``rank_at`` is row-major; fingerprints tell a 1x1x1
    grid from a 1x1 grid; ``all_reduce`` is the identity on one rank."""
    g = Grid(sizes=(2, 3, 4), axis_names=AXES3, coords=(1, 2, 3),
             device="cpu")
    assert g.rank == (1 * 3 + 2) * 4 + 3
    assert g.axis_size(("pod", "data")) == 6
    assert g.axis_index(("pod", "data")) == 1 * 3 + 2
    assert g.axis_index(("data", "pod")) == 2 * 2 + 1
    assert g.rank_at({("pod", "data"): 4}) == (1 * 3 + 1) * 4 + 3
    assert g.rank_at({"model": 0, "pod": 0}) == (0 * 3 + 2) * 4
    assert g._group_order(("pod", "data")) is None
    assert g._group_order(("data", "pod")) == [0, 2, 4, 1, 3, 5]
    one = Grid.local("cpu", axis_names=AXES3)
    assert one.sizes == (1, 1, 1) and one.coords == (0, 0, 0)
    assert one.fingerprint() != Grid.local("cpu").fingerprint()
    x = torch.ones(3)
    assert one.all_reduce(x, "pod") is x
    assert one.exchange([], []) == 0
    with pytest.raises(ValueError, match="not a grid axis"):
        g.axis_index(("pod", "rows"))
    with pytest.raises(ValueError, match="outside"):
        Grid(sizes=(2, 2), coords=(2, 0))
    with pytest.raises(ValueError, match="one per size"):
        Grid(sizes=(2, 2, 2))
    with pytest.raises(RuntimeError, match="process group"):
        g.all_reduce(x, "pod")


def _refusal(port_call, ref_call):
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_25d_rejects_unknown_rep_axis():
    """The reference's ``test_25d_rejects_unknown_rep_axis``: its message."""
    cfg = SummaConfig(grid=Grid(sizes=(2, 2)), k_blocks=4)
    ref_cfg = ref_summa.SummaConfig(
        mesh=FakeMesh({"data": 2, "model": 2}), k_blocks=4)
    msg = _refusal(
        lambda: summa.summa_25d_matmul(torch.zeros(8, 8), torch.zeros(8, 8),
                                       cfg, rep_axis="pod"),
        lambda: ref_summa.summa_25d_matmul(jnp.zeros((8, 8)),
                                           jnp.zeros((8, 8)), ref_cfg,
                                           rep_axis="pod"))
    assert "rep_axis 'pod' is not a mesh axis" in msg


def test_25d_error_message_direction():
    """The reference's ``test_25d_error_message_direction``: k_blocks=4 on
    3 replicas — the replica count must divide k_blocks, and the message
    says so."""
    port_cfg, ref_cfg = _cfg_pair((3, 2, 2), "data", "model", k_blocks=4)
    msg = _refusal(
        lambda: summa.summa_25d_matmul(torch.zeros(8, 8), torch.zeros(8, 8),
                                       port_cfg, rep_axis="pod"),
        lambda: ref_summa.summa_25d_matmul(jnp.zeros((8, 8)),
                                           jnp.zeros((8, 8)), ref_cfg,
                                           rep_axis="pod"))
    assert "replica count 3" in msg and "must divide k_blocks=4" in msg


@pytest.mark.parametrize("shapes", [((7, 8), (8, 8)), ((8, 8), (6, 8))])
def test_25d_refuses_padding_and_mismatch(shapes):
    """Operands that need padding, and a contraction mismatch, are refused
    with the reference's messages."""
    port_cfg, ref_cfg = _cfg_pair((2, 2, 2), "data", "model", k_blocks=4)
    a_shape, b_shape = shapes
    _refusal(
        lambda: summa.summa_25d_matmul(torch.zeros(a_shape),
                                       torch.zeros(b_shape), port_cfg),
        lambda: ref_summa.summa_25d_matmul(jnp.zeros(a_shape),
                                           jnp.zeros(b_shape), ref_cfg))


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(64, 128)).astype(np.float32),
            rng.normal(size=(128, 96)).astype(np.float32))


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("k_range", [(3, 2), (8, 0), (1, 7)])
@pytest.mark.parametrize("executor", ["procedural", "taskbased",
                                      "allgather"])
def test_executors_take_a_k_range(executor, k_range, local_matmul):
    """``k_steps`` panels from ``k_start`` on, on the 1x1 grid: the product
    of that K range, within the oracle tolerance of float64.  The
    all-gather executor takes the range and ignores it, as the
    reference's does: it gives the whole product."""
    k_steps, k_start = k_range
    a, b = _operands()
    cfg = SummaConfig(grid=Grid.local("cpu"), k_blocks=8,
                      local_matmul=local_matmul)
    plan = plan_matmul(64, 128, 96, cfg)
    run = summa._EXEC_IMPLS[executor]
    got = run(torch.from_numpy(a), torch.from_numpy(b), plan,
              k_steps=k_steps, k_start=k_start)
    lo, hi = k_start * 16, (k_start + k_steps) * 16
    if executor == "allgather":
        lo, hi = 0, 128
    want = a[:, lo:hi].astype(np.float64) @ b[lo:hi]
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    full = run(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert torch.equal(full, run(torch.from_numpy(a), torch.from_numpy(b),
                                 plan, k_steps=8, k_start=0))


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("k_blocks", [2, 4, 8])
def test_25d_on_one_rank_matches_reference(clean_executables, k_blocks,
                                           local_matmul):
    """``summa_25d_matmul`` on the 1x1x1 grid against the reference's on a
    1x1x1 mesh; with one replica it runs the 2-D task-based pipeline, so
    it equals ``summa_matmul`` bitwise; its executable cache counters
    follow the reference's call by call."""
    a, b = _operands(k_blocks)
    kw = dict(row_axis="data", col_axis="model", k_blocks=k_blocks,
              local_matmul=local_matmul)
    cfg = SummaConfig(grid=Grid.local("cpu", axis_names=AXES3), **kw)
    ref_cfg = ref_summa.SummaConfig(mesh=make_mesh((1, 1, 1), AXES3), **kw)
    for _ in range(2):
        got = summa.summa_25d_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                     cfg)
        want = ref_summa.summa_25d_matmul(jnp.asarray(a), jnp.asarray(b),
                                          ref_cfg)
        assert summa.executable_cache_stats() == (
            ref_summa.executable_cache_stats())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    assert torch.equal(got, summa.summa_matmul(
        torch.from_numpy(a), torch.from_numpy(b), cfg))
    stats = summa.executable_cache_stats()
    assert stats["hits"] == 1 and stats["retraces"] == stats["misses"]


@pytest.mark.parametrize("layout", range(1, len(LAYOUTS)))
def test_tuple_axis_summa_on_one_rank_matches_reference(layout):
    """``summa_matmul`` with a tuple row or column axis on the 1x1x1 grid
    against the reference's on a 1x1x1 mesh."""
    row_axis, col_axis = LAYOUTS[layout]
    a, b = _operands(layout)
    kw = dict(row_axis=row_axis, col_axis=col_axis, k_blocks=4)
    got = summa.summa_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             SummaConfig(grid=Grid.local("cpu", AXES3), **kw))
    want = ref_summa.summa_matmul(
        jnp.asarray(a), jnp.asarray(b),
        ref_summa.SummaConfig(mesh=make_mesh((1, 1, 1), AXES3), **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)


def test_two_data_parallel_axes_run_the_engine():
    """A context whose data parallelism spans two grid axes runs SUMMA with
    their tuple as the row axis (refused while a grid had two axes)."""
    from repro_torch.dist.context import ParallelCtx

    ctx = ParallelCtx(Grid.local("cpu", axis_names=AXES3),
                      dp_axes=("pod", "data"), matmul_strategy="summa")
    mm = ctx.matmul()
    assert (mm.row_axis, mm.col_axis) == (("pod", "data"), "model")
    a, b = _operands(3)
    np.testing.assert_allclose(mm(a, b).numpy(), a.astype(np.float64) @ b,
                               atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
