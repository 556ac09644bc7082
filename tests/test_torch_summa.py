"""The slice as a whole: the port's ``DistributedMatmul`` against the
reference's, in process on the 1x1 grid, and on a 2x2 grid of gloo
processes against the float64 oracle.

The operands come from ``conftest.oracle_case`` (numpy, seeded) and go
to both packages; both sides are held to ``ORACLE_ATOL``/``ORACLE_RTOL``.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ORACLE_ATOL, ORACLE_RTOL, SRC, oracle_case
from repro.core import DistributedMatmul as RefDistributedMatmul
from repro.launch.mesh import make_host_mesh
from repro_torch.core import DistributedMatmul, Grid, plan_matmul
from repro_torch.core.sparsity import BlockRankMap, random_block_mask
from repro_torch.core.summa import (
    SummaConfig,
    _apply_block_mask,
    _plan_constants,
    execute_plan,
    reference_blocksparse_matmul,
    reference_matmul,
    summa_25d_matmul,
)

from test_torch_plan import assert_plans_equal  # noqa: E402

FAMILIES = ("dense", "random", "banded", "decay", "one_sided")
STRATEGIES = ("procedural", "taskbased", "allgather")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference_results():
    """Memo of the reference's 1x1 results by (family, strategy, route)."""
    return {}


def _reference(memo, case, strategy, local_matmul):
    key = (case["family"], strategy, local_matmul)
    if key not in memo:
        mm = RefDistributedMatmul(
            make_host_mesh(1, 1), strategy=strategy, local_matmul=local_matmul
        )
        memo[key] = np.asarray(mm(
            jnp.asarray(case["a"]), jnp.asarray(case["b"]),
            a_mask=case["a_mask"], b_mask=case["b_mask"],
        ))
    return memo[key]


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_distributed_matmul_matches_reference_1x1(
    reference_results, family, strategy, local_matmul
):
    case = oracle_case(family, seed=7)
    mm = DistributedMatmul(
        Grid.local("cpu"), strategy=strategy, local_matmul=local_matmul
    )
    got = mm(case["a"], case["b"], a_mask=case["a_mask"],
             b_mask=case["b_mask"])
    assert got.shape == case["ref"].shape and got.dtype == torch.float32
    assert got.device.type == "cpu"
    plan = mm.plan(*case["shape"], a_mask=case["a_mask"],
                   b_mask=case["b_mask"])
    if family != "dense":
        assert plan.local_impl == ("bsmm" if local_matmul == "pallas"
                                   else "masked")
    want = _reference(reference_results, case, strategy, local_matmul)
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
def test_c_mask_filter_and_padding_match_reference(local_matmul):
    """Output filter, norm screening and ragged shapes through both."""
    rng = np.random.default_rng(3)
    m, k, n = 60, 100, 44  # pads to the block and grid multiples
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    a_mask = random_block_mask(6, 10, 0.5, seed=1)
    b_mask = random_block_mask(10, 4, 0.6, seed=2)
    c_mask = np.ones((6, 4), bool)
    c_mask[1, 2] = c_mask[4, 0] = False
    kw = dict(a_mask=a_mask, b_mask=b_mask, c_mask=c_mask,
              a_norms=rng.uniform(0.1, 1.0, (6, 10)) * a_mask,
              b_norms=rng.uniform(0.1, 1.0, (10, 4)) * b_mask,
              filter_eps=0.05)
    port = DistributedMatmul(Grid.local("cpu"), local_matmul=local_matmul)
    ref = RefDistributedMatmul(make_host_mesh(1, 1), local_matmul=local_matmul)
    got = port(a, b, **kw).numpy()
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b), **kw))
    np.testing.assert_allclose(got, want, atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    assert np.all(got[10:20, 22:33] == 0) and np.all(got[40:50, :11] == 0)
    dense = DistributedMatmul(Grid.local("cpu"), k_blocks=4,
                              local_matmul=local_matmul)
    np.testing.assert_allclose(
        dense(a, b).numpy(), a.astype(np.float64) @ b, atol=ORACLE_ATOL,
        rtol=ORACLE_RTOL,
    )


def _tile_map_case(seed=11):
    """A and B block-sparse at fill 0.3, (64 x 128) @ (128 x 1024): B's
    mask blocks are 16 x 128, finer than ``bsmm``'s 256-column tile, and
    its dead blocks kill some of A's products under every tile."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, 128)).astype(np.float32)
    b = rng.normal(size=(128, 1024)).astype(np.float32)
    a_mask = random_block_mask(8, 8, 0.3, seed=seed)
    b_mask = random_block_mask(8, 8, 0.3, seed=seed + 1)
    ref = ((a * np.kron(a_mask, np.ones((8, 16)))).astype(np.float64)
           @ (b * np.kron(b_mask, np.ones((16, 128)))))
    return dict(a=a, b=b, a_mask=a_mask, b_mask=b_mask, ref=ref)


@pytest.mark.parametrize("compiled", [True, False])
def test_bsmm_tile_map_matches_float64_1x1(compiled):
    """Where B's mask kills some of A's products, the plan's constants
    hold a map a 256-column tile and the product through it equals the
    float64 product of the masked operands."""
    case = _tile_map_case()
    mm = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
    kw = dict(a_mask=case["a_mask"], b_mask=case["b_mask"])
    plan = mm.plan(64, 128, 1024, **kw)
    assert plan.local_impl == "bsmm"
    consts = _plan_constants(plan, (64, 128), (128, 1024),
                             torch.device("cpu"))
    assert consts["walk"].shape[:2] == (plan.local_cols.shape[2], 4)
    a_pad = torch.from_numpy(case["a"])
    got = execute_plan(a_pad, torch.from_numpy(case["b"]), plan,
                       compiled=compiled)
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    np.testing.assert_allclose(mm(case["a"], case["b"], **kw).numpy(),
                               case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


def test_plan_cache_and_bfloat16_operands():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    mm = DistributedMatmul(Grid.local("cpu"), k_blocks=4,
                           local_matmul="pallas")
    mm(a, b)
    mm(a, b)
    assert mm.cache_stats()["plan"] == {"size": 1, "hits": 1, "misses": 1}
    c = mm(a.bfloat16(), b.bfloat16())
    assert c.dtype == torch.bfloat16  # a new plan: itemsize 2
    assert mm.cache_stats()["plan"]["size"] == 2
    want = reference_matmul(a.bfloat16(), b.bfloat16())
    np.testing.assert_allclose(c.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2 * 64 ** 0.5)
    mm.reset_cache_stats()
    assert mm.cache_stats()["plan"]["hits"] == 0


def test_reference_oracles_and_block_mask():
    case = oracle_case("random", seed=2)
    a, b = torch.from_numpy(case["a"]), torch.from_numpy(case["b"])
    got = reference_blocksparse_matmul(a, b, case["a_mask"], case["b_mask"])
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    x = torch.ones(6, 8)
    mask = np.array([[True, False], [False, True]])
    full = _apply_block_mask(x, mask)
    assert full[:3, :4].all() and not full[:3, 4:].any()
    # a tile at (3, 4) of a matrix blocked (3, 4): only block (1, 1)
    tile = _apply_block_mask(torch.ones(3, 4), mask, (3, 4), origin=(3, 4))
    assert tile.all()
    with pytest.raises(ValueError):
        _apply_block_mask(torch.ones(5, 8), mask)


def test_unported_routes_raise():
    """``contract`` (A6), the tuner (A1) and the pull and stationary routes
    (A7), which raised here until they were ported, now give the
    reference's products; ``summa_25d_matmul`` (A3), which raised too,
    now refuses a grid without its replica axis with the reference's
    message."""
    mm = DistributedMatmul(Grid.local("cpu"))
    ref = RefDistributedMatmul(make_host_mesh(1, 1))
    a = np.random.default_rng(4).normal(size=(16, 16)).astype(np.float32)
    mask = np.eye(2, dtype=bool)
    for kw in (dict(tune=True),
               dict(a_mask=mask, b_mask=mask, comm_mode="pull"),
               dict(a_mask=mask, b_mask=mask, stationarity="A"),
               dict(stationarity="B")):
        np.testing.assert_allclose(
            mm(a, a, **kw).numpy(), np.asarray(ref(jnp.asarray(a),
                                                   jnp.asarray(a), **kw)),
            atol=ORACLE_ATOL, rtol=ORACLE_RTOL, err_msg=str(kw))
    np.testing.assert_allclose(
        mm.contract("ab,bc->ac", a, a).data.numpy(),
        np.asarray(ref.contract("ab,bc->ac", jnp.asarray(a),
                                jnp.asarray(a)).data),
        atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    with pytest.raises(ValueError,
                       match="rep_axis 'pod' is not a mesh axis"):
        summa_25d_matmul(torch.from_numpy(a), torch.from_numpy(a),
                         SummaConfig(grid=Grid.local("cpu")))
    # a dense-stored rank map plans rank-aware and runs the masked DAG
    ones = np.ones((16, 16), np.float32)
    got = mm(ones, ones, a_ranks=BlockRankMap(
        ranks=np.eye(2, dtype=np.int32) * 3, bm=8, bk=8))
    np.testing.assert_allclose(
        got.numpy(), (ones * np.kron(np.eye(2), np.ones((8, 8)))) @ ones)


@pytest.mark.parametrize("mode", ["pull", "A", "B"])
@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("family", ["random", "banded"])
def test_pull_and_stationary_match_reference_1x1(family, local_matmul, mode):
    """The one-sided pull route and the A-/B-stationary schedules against
    the reference's, and pull against the broadcast masked DAG bitwise
    (one card reads the same panels in the same order), as the reference
    pins it."""
    case = oracle_case(family, seed=5)
    masks = dict(a_mask=case["a_mask"], b_mask=case["b_mask"])
    kw = dict(comm_mode="pull") if mode == "pull" else dict(stationarity=mode)
    mm = DistributedMatmul(Grid.local("cpu"), local_matmul=local_matmul)
    ref = RefDistributedMatmul(make_host_mesh(1, 1),
                               local_matmul=local_matmul)
    plan = mm.plan(*case["shape"], **masks, **kw)
    assert (plan.comm_mode, plan.stationarity) == (
        kw.get("comm_mode", "broadcast"), kw.get("stationarity", "C"))
    got = mm(case["a"], case["b"], **masks, **kw)
    want = np.asarray(ref(jnp.asarray(case["a"]), jnp.asarray(case["b"]),
                          **masks, **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    if mode == "pull" and mm.plan(*case["shape"], **masks).local_impl == (
            "masked"):  # the bsmm route is a different algorithm
        assert torch.equal(got, mm(case["a"], case["b"], **masks))


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("family", ["dense", "random"])
def test_tuned_product_matches_reference_1x1(family, local_matmul):
    """``tune=True``: the tuned plan equals the reference's (its ``tuned``
    record included), tuned and untuned plans are cached apart, and the
    product equals the reference's tuned product."""
    case = oracle_case(family, seed=6)
    masks = dict(a_mask=case["a_mask"], b_mask=case["b_mask"])
    mm = DistributedMatmul(Grid.local("cpu"), k_blocks=8,
                           local_matmul=local_matmul)
    ref = RefDistributedMatmul(make_host_mesh(1, 1), k_blocks=8,
                               local_matmul=local_matmul)
    plan = mm.plan(*case["shape"], **masks, tune=True)
    ref_plan = ref.plan(*case["shape"], **masks, tune=True)
    assert plan.tuned == ref_plan.tuned and plan.tuned is not None
    assert_plans_equal(plan, ref_plan)
    assert mm.plan(*case["shape"], **masks).tuned is None
    assert mm.cache_stats()["plan"]["size"] == 2
    got = mm(case["a"], case["b"], **masks, tune=True)
    want = np.asarray(ref(jnp.asarray(case["a"]), jnp.asarray(case["b"]),
                          **masks, tune=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


def test_grid_geometry_and_local_collectives():
    g = Grid.local("cpu")
    assert g.shape == {"data": 1, "model": 1} and g.coords == (0, 0)
    x = torch.arange(6.0).reshape(2, 3)
    out, work = g.broadcast(x, 0, "model")
    assert out is x and work is None
    assert g.all_gather(x, "data", dim=0) is x
    planning = Grid(sizes=(2, 4))
    assert planning.shape == {"data": 2, "model": 4}
    assert planning.axis_index("model") == 0
    with pytest.raises(RuntimeError, match="process group"):
        planning.broadcast(x, 1, "model")
    with pytest.raises(ValueError, match="not a grid axis"):
        planning.axis_index("pod")
    assert planning.fingerprint() != Grid(sizes=(4, 2)).fingerprint()
    with pytest.raises(RuntimeError, match="not initialised"):
        Grid.from_process_group(1, 1, device="cpu")
    # the grid sets the entry point's device: no silent CPU fallback
    assert Grid.local().device.type == "cuda"
    assert Grid().device.type == "cuda" and planning.device.type == "cuda"
    cfg = SummaConfig(grid=Grid(sizes=(2, 2)))
    plan = plan_matmul(8, 8, 8, cfg)
    with pytest.raises(ValueError, match="tiles"):
        execute_plan(torch.ones(8, 8), torch.ones(8, 8), plan)


def test_grid_without_device_never_computes_on_the_cpu():
    """A grid built without a device is on cuda: CPU operands are moved to
    the card, and where there is none the move raises; the product never
    runs on the CPU."""
    mm = DistributedMatmul(Grid(), local_matmul="pallas")
    a = torch.ones(8, 8)
    if torch.cuda.is_available():
        assert mm(a, a).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            mm(a, a)


# ---------------------------------------------------------------------------
# 2x2 grid of gloo processes
# ---------------------------------------------------------------------------

_RANK_PROGRAM = r"""
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.analysis import spans
from repro_torch.core import DistributedMatmul, Grid
from repro_torch.core import summa


def parent_k_shard(x_loc, cfg, *, k_dim):
    # the stationary re-layout as it was before it moved only the K
    # shard: the whole operand all-gathered along both axes, then sliced
    g = cfg.grid
    if k_dim == 0:
        full = g.all_gather(g.all_gather(x_loc, cfg.row_axis, dim=0),
                            cfg.col_axis, dim=1)
        w = full.shape[0] // cfg.p_col
        j = g.axis_index(cfg.col_axis)
        return full[j * w:(j + 1) * w]
    full = g.all_gather(g.all_gather(x_loc, cfg.col_axis, dim=1),
                        cfg.row_axis, dim=0)
    w = full.shape[1] // cfg.p_row
    i = g.axis_index(cfg.row_axis)
    return full[:, i * w:(i + 1) * w]


rank, rdv, data, spec = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
grid = Grid.from_process_group(2, 2, device="cpu")
case = np.load(data)
masks = {name: case[name] for name in ("a_mask", "b_mask")
         if name in case.files}
out = {}
for name, mm_kw, call_kw, masked in json.loads(spec):
    mm = DistributedMatmul(grid, k_blocks=8, **mm_kw)
    kw = dict(call_kw, **(masks if masked else {}))
    m, k = case["a"].shape
    plan = mm.plan(m, k, case["b"].shape[1], **kw)
    with spans.recording():
        c = mm(case["a"], case["b"], **kw)
        recs = spans.records()
    # what the stationary re-layout received, and the spans of the panel
    # broadcasts and of the waits for them (not the re-layout's own)
    exchanges = {r.id for r in recs if r.name == "grid.exchange"}
    mine = [sum(r.counters.get("grid.recv_bytes", 0) for r in recs
                if r.id in exchanges),
            sum(r.name == "grid.broadcast" for r in recs),
            sum(r.name == "grid.wait" and r.parent not in exchanges
                for r in recs)]
    recv = [None] * 4
    dist.all_gather_object(recv, mine)
    out[name + "-recv"] = np.array([r[0] for r in recv])
    out[name + "-spans"] = np.array([r[1:] for r in recv])
    out[name + "-steps"] = np.array([len(plan.live_panels), plan.k_steps])
    # bsmm's block counters and the rank of its map (3: a list a tile)
    walk = []
    if plan.local_impl == "bsmm":
        n_loc = plan.n_pad // plan.p_col
        walk = [sum(r.counters.get("bsmm.blocks_" + what, 0) for r in recs)
                for what in ("multiplied", "useful")]
        walk.append(summa._bsmm_walk(plan, grid.axis_index(plan.cfg.row_axis),
                                     grid.axis_index(plan.cfg.col_axis),
                                     n_loc)[0].ndim)
    walks = [None] * 4
    dist.all_gather_object(walks, walk)
    out[name + "-walk"] = np.array(walks)
    if plan.stationarity != "C":
        new_k_shard, summa._k_shard = summa._k_shard, parent_k_shard
        out[name + "-parent"] = mm(case["a"], case["b"], **kw).numpy()
        summa._k_shard = new_k_shard
    out[name] = c.numpy()
    out[name + "-impl"] = np.array(plan.local_impl)
    out[name + "-route"] = np.array(
        [plan.cfg.strategy, plan.comm_mode, plan.stationarity,
         str(plan.tuned is not None)])
if rank == 0:
    np.savez(data.replace("case", "out"), **out)
dist.destroy_process_group()
"""

_ENGINE = [("xla", "taskbased"), ("pallas", "taskbased"),
           ("xla", "procedural"), ("xla", "allgather")]


def _runs(family):
    """(name, DistributedMatmul kwargs, call kwargs, masked) of a family."""
    if family == "tile_map":
        return [(f"{route}-tile_map", dict(local_matmul=route), {}, True)
                for route in ("xla", "pallas")]
    if family in ("dense", "banded"):
        return [(f"{route}-{strategy}",
                 dict(strategy=strategy, local_matmul=route), {}, True)
                for route, strategy in _ENGINE]
    call = {"pull": dict(comm_mode="pull"),
            "stationary_A": dict(stationarity="A"),
            "stationary_B": dict(stationarity="B"),
            "tuned": dict(tune=True)}[family]
    runs = [(f"{route}-{family}-masked", dict(local_matmul=route), call, True)
            for route in ("xla", "pallas")]
    if family != "pull":  # pull needs block structure
        runs += [(f"{route}-{family}-dense", dict(local_matmul=route), call,
                  False) for route in ("xla", "pallas")]
    return runs


def _stationary_traffic(stationarity):
    """Per rank of the 2x2 grid, row-major: the bytes a stationary
    re-layout of the 64x128 @ 128x96 fp32 product must deliver to it
    (its K shard, less what its own tile holds), and what
    ``sched.taskgraph._emit_stationary`` prices its group's relay."""
    from repro_torch.sched.taskgraph import BCAST_FACTOR, from_plan

    plan = DistributedMatmul(Grid(sizes=(2, 2)), k_blocks=8).plan(
        64, 128, 96, stationarity=stationarity)
    relay = "bcast_b" if stationarity == "A" else "bcast_a"
    price = np.zeros(4)
    for task in from_plan(plan).tasks:
        if task.kind == relay:
            price[list(task.devices)] = task.bytes
    # the moving tile: B's (64 x 48) under "A" (its K over the grid rows,
    # shards over the columns), A's (32 x 64) under "B"; a rank holds a
    # part of its own shard when its two coordinates agree
    tile = 64 * 48 * 4 if stationarity == "A" else 32 * 64 * 4
    held = np.array([tile if i == j else 0 for i in (0, 1) for j in (0, 1)])
    return price / BCAST_FACTOR - held, price


@pytest.mark.parametrize("family", ["dense", "banded", "pull", "stationary_A",
                                    "stationary_B", "tuned", "tile_map"])
def test_2x2_gloo_grid_matches_oracle(tmp_path, family):
    """Four gloo processes form the 2x2 grid: panel broadcasts along grid
    rows and columns, the all-gather strategy, and the per-rank BSMM maps
    (banded masks give each rank its own CSR map); the one-sided pull
    route, the A-/B-stationary schedules (their re-layout and
    reduce-scatter) and tuned plans, on banded masks and unmasked; and
    ``bsmm`` walking each rank's map a 256-column tile where B's mask
    (blocks finer than the tile) kills some of A's products: it multiplies
    the useful block products alone, against the float64 product.

    The stationary re-layout delivers each rank only its K shard: the
    bytes it receives are the shard the task graph prices for its group
    (less the factor of the reference's broadcast-as-allreduce) less the
    part its own tile holds, masked or not (zero blocks travel, as in the
    reference's re-layout); C equals bitwise the C of the earlier
    re-layout, which all-gathered the whole operand.  Each rank records
    (``analysis.spans``) two ``grid.broadcast`` and two ``grid.wait``
    spans per panel it multiplies (every K step, or every live panel),
    none on the all-gather and stationary routes, and reads the bytes
    its re-layout received from ``grid.recv_bytes`` in ``grid.exchange``."""
    if family == "tile_map":
        case = _tile_map_case()
    else:
        case = oracle_case("dense" if family == "dense" else "banded",
                           seed=7)
    data = tmp_path / "case.npz"
    masks = {} if case["a_mask"] is None else dict(
        a_mask=case["a_mask"], b_mask=case["b_mask"])
    np.savez(data, a=case["a"], b=case["b"], **masks)
    runs = _runs(family)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_PROGRAM, str(rank),
             str(tmp_path / "rdv"), str(data), json.dumps(runs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(4)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    out = np.load(tmp_path / "out.npz")
    dense_ref = case["a"].astype(np.float64) @ case["b"].astype(np.float64)
    for name, _, call_kw, masked in runs:
        np.testing.assert_allclose(
            out[name], case["ref"] if masked else dense_ref,
            atol=ORACLE_ATOL, rtol=ORACLE_RTOL, err_msg=name)
        strategy, comm_mode, stationarity, tuned = out[name + "-route"]
        assert comm_mode == call_kw.get("comm_mode", "broadcast"), name
        assert tuned == str(bool(call_kw.get("tune"))), name
        if "stationarity" in call_kw:
            assert stationarity == call_kw["stationarity"], name
            np.testing.assert_array_equal(out[name], out[name + "-parent"],
                                          err_msg=name)
            want, price = _stationary_traffic(stationarity)
            np.testing.assert_array_equal(out[name + "-recv"], want,
                                          err_msg=name)
            assert (out[name + "-recv"] < price).all(), name
        elif stationarity == "C":
            assert not out[name + "-recv"].any(), name
        live, k_steps = out[name + "-steps"]
        impl = str(out[name + "-impl"])
        if stationarity != "C":
            panels = 0
        elif impl in ("bsmm", "masked", "ranksparse"):
            panels = live
        else:
            panels = 0 if strategy == "allgather" else k_steps
        assert (out[name + "-spans"] == 2 * panels).all(), (
            name, out[name + "-spans"], panels)
    if family in ("dense", "banded"):
        want_impl = "dense" if family == "dense" else "bsmm"
        assert str(out["pallas-taskbased-impl"]) == want_impl
    if family == "tile_map":
        assert str(out["pallas-tile_map-impl"]) == "bsmm"
        for multiplied, useful, ndim in out["pallas-tile_map-walk"]:
            assert multiplied == useful > 0 and ndim == 3


# ---------------------------------------------------------------------------
# the executable cache and the plan-and-execute wrappers
# ---------------------------------------------------------------------------


@pytest.fixture
def clean_executables():
    """Both packages' executable caches and autotune caches start and end
    empty (they are process-wide)."""
    from repro.core import summa as ref_summa
    from repro_torch.core import summa as port_summa
    from repro_torch.kernels import autotune as at

    at.set_autotune_cache(None)
    port_summa.clear_executable_cache()
    ref_summa.clear_executable_cache()
    yield port_summa, ref_summa
    at.set_autotune_cache(None)
    port_summa.clear_executable_cache()
    ref_summa.clear_executable_cache()


def _rank_pair(seed=5):
    """The same factor payload in both packages, and a B."""
    from repro.core import decay_rank_map as ref_rank_map
    from repro.core import synthesize_rank_csr as ref_synth
    from repro_torch.core.sparsity import decay_rank_map, synthesize_rank_csr

    kw = dict(max_rank=8, decay=0.8)
    port = synthesize_rank_csr(decay_rank_map(4, 4, 32, 32, **kw), seed=seed)
    ref = ref_synth(ref_rank_map(4, 4, 32, 32, **kw), seed=seed)
    np.testing.assert_array_equal(port.u, ref.u)
    b = np.random.default_rng(seed).normal(size=(128, 96)).astype(np.float32)
    return port, ref, b


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("family", FAMILIES)
def test_compiled_equals_eager_bitwise(clean_executables, family,
                                       local_matmul):
    """Dense, masked and ``bsmm`` plans: the cached executable equals the
    eager interpreter bitwise, on a first call and a cached one."""
    port_summa, _ = clean_executables
    case = oracle_case(family, seed=9)
    masks = dict(a_mask=case["a_mask"], b_mask=case["b_mask"])
    got = [DistributedMatmul(Grid.local("cpu"), local_matmul=local_matmul)(
        case["a"], case["b"], **masks) for _ in range(2)]
    eager = DistributedMatmul(Grid.local("cpu"), local_matmul=local_matmul,
                              compiled=False)(case["a"], case["b"], **masks)
    assert torch.equal(got[0], eager) and torch.equal(got[1], eager)
    stats = port_summa.executable_cache_stats()
    assert stats == {"hits": 1, "misses": 1, "retraces": 1, "size": 1}
    np.testing.assert_allclose(eager.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
def test_rank_and_nonuniform_compiled_equal_eager(clean_executables,
                                                  local_matmul):
    """The factor route's executable (``execute_rank_plan``) and a
    nonuniform product's equal their eager routes bitwise."""
    from repro_torch.core import NonuniformMatmul
    from repro_torch.core.blocking import nonuniform_tiling

    rank, _, b = _rank_pair()
    outs = {}
    for compiled in (True, False):
        mm = DistributedMatmul(Grid.local("cpu"), local_matmul=local_matmul,
                               compiled=compiled)
        assert mm.plan(128, 128, 96, a_ranks=rank).local_impl == "ranksparse"
        outs[compiled] = mm(None, b, a_ranks=rank)
        tilings = [nonuniform_tiling(70 + 10 * i, 5, seed=i) for i in range(3)]
        nm = NonuniformMatmul(mm, *tilings, tile=16)
        rng = np.random.default_rng(2)
        a2 = rng.normal(size=(70, 80)).astype(np.float32)
        b2 = rng.normal(size=(80, 90)).astype(np.float32)
        outs[compiled, "nu"] = nm(a2, b2)
    assert torch.equal(outs[True], outs[False])
    assert torch.equal(outs[True, "nu"], outs[False, "nu"])
    np.testing.assert_allclose(outs[True, "nu"].numpy(), a2.astype(
        np.float64) @ b2, atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    stats = clean_executables[0].executable_cache_stats()
    assert stats["misses"] == stats["retraces"] == stats["size"] == 2


def test_executable_cache_follows_the_reference(clean_executables):
    """The same products through both packages leave equal counters (the
    plan and executable sections), and builds never exceed misses; a warm
    plan matches the reference's answer and makes the next call a hit."""
    port_summa, ref_summa = clean_executables
    case = oracle_case("random", seed=4)
    rank, ref_rank, b = _rank_pair()
    masks = dict(a_mask=case["a_mask"], b_mask=case["b_mask"])
    mm = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
    ref = RefDistributedMatmul(make_host_mesh(1, 1), local_matmul="pallas")
    a_j, b_j = jnp.asarray(case["a"]), jnp.asarray(case["b"])
    calls = [
        (lambda: mm(case["a"], case["b"]), lambda: ref(a_j, b_j)),
        (lambda: mm(case["a"], case["b"], **masks),
         lambda: ref(a_j, b_j, **masks)),
        (lambda: mm(None, b, a_ranks=rank),
         lambda: ref(None, jnp.asarray(b), a_ranks=ref_rank)),
        (lambda: mm(case["a"].astype(np.float32), case["b"], tune=True),
         lambda: ref(a_j, b_j, tune=True)),
    ]
    for _ in range(2):
        for port_call, ref_call in calls:
            port_call()
            ref_call()
            got = mm.cache_stats()
            assert {k: got[k] for k in ("plan", "executable")} == {
                k: ref.cache_stats()[k] for k in ("plan", "executable")}
            assert got["executable"]["retraces"] <= got["executable"][
                "misses"]
    assert got["executable"]["hits"] == got["executable"]["misses"] == 4
    for shape, kw in (((64, 128, 96), {}), ((48, 64, 32), masks),
                      ((128, 128, 96), dict(a_ranks=rank))):
        ref_kw = dict(kw, a_ranks=ref_rank) if "a_ranks" in kw else kw
        plan, ref_plan = mm.plan(*shape, **kw), ref.plan(*shape, **ref_kw)
        assert port_summa.warm_plan_executable(plan, torch.float32) == (
            ref_summa.warm_plan_executable(ref_plan, jnp.float32))
        assert port_summa.executable_cache_stats() == (
            ref_summa.executable_cache_stats())


def test_autotune_fingerprint_joins_the_plan_key(clean_executables):
    """A non-empty autotune cache adds its fingerprint to every key (a
    new executable); an empty one adds nothing (the old one is found)."""
    port_summa, _ = clean_executables
    from repro_torch.kernels import autotune as at

    a = np.ones((32, 32), np.float32)
    mm = DistributedMatmul(Grid.local("cpu"))
    mm(a, a)
    table = at.KernelAutotuner(device_kind="cpu")
    table.table[at.bucket_key(256, 256, 256)] = {
        "winner": "xla", "times_s": {"xla": 1e-5, "pallas": 2e-5},
        "tiles": None}
    at.set_autotune_cache(table)
    assert port_summa._autotune_key_suffix() == (table.fingerprint(),)
    mm(a, a)
    assert port_summa.executable_cache_stats()["misses"] == 2
    at.set_autotune_cache(None)
    assert port_summa._autotune_key_suffix() == ()
    mm(a, a)
    assert port_summa.executable_cache_stats() == {
        "hits": 1, "misses": 2, "retraces": 2, "size": 2}


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
def test_summa_wrappers_match_reference(clean_executables, local_matmul):
    """``summa_matmul`` and ``summa_blocksparse_matmul`` over global
    operands give the reference's products and refuse what it refuses,
    with its messages."""
    from repro.core.summa import SummaConfig as RefSummaConfig
    from repro.core.summa import summa_blocksparse_matmul as ref_bs
    from repro.core.summa import summa_matmul as ref_sm
    from repro_torch.core.summa import summa_blocksparse_matmul, summa_matmul

    cfg = SummaConfig(grid=Grid.local("cpu"), k_blocks=8,
                      local_matmul=local_matmul)
    ref_cfg = RefSummaConfig(mesh=make_host_mesh(1, 1), k_blocks=8,
                             local_matmul=local_matmul)
    case = oracle_case("banded", seed=3)
    a, b = torch.from_numpy(case["a"]), torch.from_numpy(case["b"])
    a_j, b_j = jnp.asarray(case["a"]), jnp.asarray(case["b"])
    np.testing.assert_allclose(
        summa_matmul(a, b, cfg).numpy(), np.asarray(ref_sm(a_j, b_j, ref_cfg)),
        atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    got = summa_blocksparse_matmul(a, b, case["a_mask"], case["b_mask"], cfg)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_bs(a_j, b_j, case["a_mask"],
                                       case["b_mask"], ref_cfg)),
        atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    ragged = (torch.ones(60, 100), torch.ones(100, 44))
    for port_call, ref_call in (
            (lambda: summa_matmul(*ragged, cfg),
             lambda: ref_sm(jnp.ones((60, 100)), jnp.ones((100, 44)),
                            ref_cfg)),
            (lambda: summa_matmul(a, a, cfg),
             lambda: ref_sm(a_j, a_j, ref_cfg)),
            (lambda: summa_blocksparse_matmul(
                *ragged, np.ones((8, 8), bool), np.ones((8, 4), bool), cfg),
             lambda: ref_bs(jnp.ones((60, 100)), jnp.ones((100, 44)),
                            np.ones((8, 8), bool), np.ones((8, 4), bool),
                            ref_cfg))):
        with pytest.raises(ValueError) as want:
            ref_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
