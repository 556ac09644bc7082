"""Eight gloo processes: the port's three-axis grid, tuple axes, 2.5D
SUMMA and expert parallelism across ranks, against the JAX package.

One spawn of eight CPU processes runs every 8-rank case; each is held
against the reference's result for the same numpy inputs, computed in
the test process on a one-device mesh of the same axes, with
``ORACLE_ATOL``/``ORACLE_RTOL`` (products) or 1e-4 (the MoE layer, as
the reference's own expert-parallel test):

* 2.5D SUMMA on a (2, 2, 2) grid ``("pod", "data", "model")``, replicas
  over ``pod``, at ``k_blocks`` 2, 4 and 8 (the reference's
  ``tests/test_plan.py::test_summa_25d_oracle_on_222_mesh``);
* SUMMA with tuple axes: ``row_axis=("pod", "data")`` (the reference's
  ``tests/test_summa.py`` multi-pod case), and a tuple column axis in
  the opposite of the grid's order, ``("model", "pod")``, on the
  task-based and all-gather strategies and the A-/B-stationary
  re-layouts;
* expert parallelism on a (2, 4) grid: mixtral-8x7b's and kimi-k2's
  SMOKE MoE layers stored as each rank's blocks
  (``dist.partitioning.shard_params``: experts over the 4-rank ``model``
  axis, ``d_model`` over ``data``) and run on the rank's batch rows,
  against the one-rank route (the reference's
  ``tests/test_moe.py::test_expert_parallel_equivalence_subprocess``);
  the gradient through them (every parameter's and the activations',
  gathered whole) and one Adafactor train step of each SMOKE model on
  its sharded state, against the reference's whole gradient and step on
  one device (at 1e-4 of each leaf's largest value, as
  ``tests/test_torch_train.py``);
* the ring collective matmul on the (2, 4) grid: ``allgather_matmul`` at
  lookahead 1, 2 and 4, with ``batch_axes=("data",)``, and its weight
  gradient (the reference's ``tests/test_dist.py`` ``ALLGATHER_MM_CODE``
  cases), then ``project`` under ``"allgather"`` and ``"auto"`` (which
  picks the ring, as in ``PROJECT_AUTO_CODE``) on the rank's rows and
  its stored block of the weight, with its gradients.

Every rank gathers its results whole.

Run it alone with ``pytest tests/test_torch_grid8.py`` (~40 s).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ORACLE_ATOL, ORACLE_RTOL, SRC
from repro.configs.registry import get_config as ref_get_config
from repro.core import DistributedMatmul as RefDistributedMatmul
from repro.core import summa as ref_summa
from repro.dist.context import ParallelCtx as RefCtx
from repro.launch.mesh import make_mesh
from repro.dist.collective_matmul import allgather_matmul as ref_allgather
from repro.dist.collective_matmul import project as ref_project
from repro.models import moe as ref_moe
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.data import SyntheticData as RefData
from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import moe
from repro_torch.models.convert import load_leaves, reference_leaves
from repro_torch.train.tree import leaves as tree_leaves

AXES3 = ("pod", "data", "model")
K_BLOCKS_25D = (2, 4, 8)
#: name -> (row_axis, col_axis, strategy or stationarity) of the
#: tuple-axis products, all at k_blocks 4
TUPLE_CASES = {
    "rows-taskbased": (("pod", "data"), "model", "taskbased"),
    "cols-taskbased": ("data", ("model", "pod"), "taskbased"),
    "cols-allgather": ("data", ("model", "pod"), "allgather"),
    "rows-stationary_A": (("pod", "data"), "model", "A"),
    "cols-stationary_A": ("data", ("model", "pod"), "A"),
    "cols-stationary_B": ("data", ("model", "pod"), "B"),
}
MOE_ARCHS = ("mixtral-8x7b", "kimi-k2-1t-a32b")
RING_LOOKAHEADS = (1, 2, 4)
STEP_BATCH, STEP_SEQ = 4, 16

_RANK_PROGRAM = r"""
import dataclasses
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core import DistributedMatmul, Grid, SummaConfig
from repro_torch.core.summa import summa_25d_matmul, summa_matmul
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import moe
from repro_torch.models.convert import (load_leaves,
                                        train_state_from_reference,
                                        train_state_to_numpy)
from repro_torch.analysis.cost import analyze_step
from repro_torch.dist.collective_matmul import allgather_matmul, project
from repro_torch.dist.partitioning import gather_block, shard_params
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves as tree_leaves, unflatten

rank, rdv, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=8)
torch.set_num_threads(1)
case = np.load(data)
spec = eval(str(case["spec"]))
a, b = torch.from_numpy(case["a"]), torch.from_numpy(case["b"])
out = {}
grid3 = Grid.from_process_group(2, 2, 2, axis_names=spec["axes"],
                                device="cpu")
for kb in spec["k_blocks_25d"]:
    cfg = SummaConfig(grid=grid3, row_axis="data", col_axis="model",
                      strategy="taskbased", k_blocks=kb)
    out[f"25d-{kb}"] = summa_25d_matmul(a, b, cfg).numpy()
for name, (row, col, how) in spec["tuple_cases"].items():
    if how in ("A", "B"):
        mm = DistributedMatmul(grid3, row_axis=row, col_axis=col, k_blocks=4)
        out[name] = mm(a, b, stationarity=how).numpy()
    else:
        cfg = SummaConfig(grid=grid3, row_axis=row, col_axis=col,
                          strategy=how, k_blocks=4)
        out[name] = summa_matmul(a, b, cfg).numpy()
ctx = ParallelCtx(Grid.from_process_group(2, 4, device="cpu"))
grid = ctx.grid


def rows(x):  # this rank's rows of a global batch (over data)
    return torch.from_numpy(np.split(x, 2)[grid.axis_index("data")])


for arch in spec["moe_archs"]:
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=32.0))
    leaves = {k.split("/", 1)[1]: case[k] for k in case.files
              if k.startswith(arch + "/")}
    layer = shard_params(load_leaves(
        moe.MoE(cfg, ep=4, dtype=torch.float32, device="cpu"), leaves), grid)
    y, aux = moe.moe_ffn(layer, rows(case[arch + "-x"]), cfg, ctx)
    out["ep-" + arch] = grid.all_gather(y, "data", 0).numpy()
    out["aux-" + arch] = aux.numpy()
    # the gradient through expert parallelism: each rank's loss is its
    # rows' sum of squares and the (global) aux loss
    layer.requires_grad_(True)
    x = rows(case[arch + "-x"]).requires_grad_(True)
    y, aux = moe.moe_ffn(layer, x, cfg, ctx)
    ((y ** 2).sum() + aux).backward()
    ts.sync_grads(layer, ctx)
    out[f"grad-{arch}/x"] = grid.all_gather(x.grad, "data", 0).numpy()
    for name, p in layer.named_parameters():
        out[f"grad-{arch}/{name}"] = gather_block(p.grad, p.spec,
                                                  grid).numpy()
    # one train step of the SMOKE model on the grid
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    flat = {k.split("/", 1)[1]: case[k] for k in case.files
            if k.startswith("state-" + arch + "/")}
    state = train_state_from_reference(unflatten(flat), cfg, "cpu", ep=4,
                                       ctx=ctx)
    batch = {k.split("/", 1)[1]: case[k] for k in case.files
             if k.startswith("batch-" + arch + "/")}
    opt = make_optimizer(OptimizerConfig(name="adafactor", total_steps=10,
                                         warmup_steps=1))
    state, metrics = ts.build_train_step(cfg, ctx, opt)(state, batch)
    for k, v in tree_leaves(train_state_to_numpy(state, ctx)):
        out[f"step-{arch}/{k}"] = v
    for k, v in metrics.items():
        out[f"metric-{arch}/{k}"] = v.numpy()
# the ring collective matmul: tiles gathered back to whole on every rank
x, w = case["ring_x"], case["ring_w"]
me = grid.axis_index("model")
w_loc = torch.from_numpy(np.ascontiguousarray(np.split(w, 4, axis=1)[me]))
x_model = torch.from_numpy(np.split(x, 4)[me])
for la in spec["lookaheads"]:
    tile = allgather_matmul(x_model, w_loc, grid=grid, axis="model",
                            lookahead=la)
    out[f"ring-{la}"] = grid.all_gather(tile, "model", 1).numpy()
x_rows = torch.from_numpy(np.split(x, 8)[grid.axis_index(("data", "model"))])
tile = allgather_matmul(x_rows, w_loc, grid=grid, axis="model",
                        batch_axes=("data",))
out["ring-batch"] = grid.all_gather(grid.all_gather(tile, "model", 1),
                                    "data", 0).numpy()
w_grad = w_loc.clone().requires_grad_(True)
(allgather_matmul(x_model, w_grad, grid=grid, axis="model") ** 2
 ).sum().backward()
out["ring-dw"] = grid.all_gather(w_grad.grad, "model", 1).numpy()
for strategy in ("allgather", "auto"):
    # the rank's rows, and its block of an FFN kernel ("data", "model")
    xs = rows(x).requires_grad_(True)
    holder = torch.nn.Module()
    holder.w = torch.nn.Parameter(torch.from_numpy(case["ring_w_wide"]))
    ws = shard_params(holder, grid).w
    y, wc, _ = analyze_step(
        project, xs, ws, ParallelCtx(grid, matmul_strategy=strategy))
    (y ** 2).sum().backward()
    ts.sync_grads(holder, ctx)
    out[f"project-{strategy}"] = grid.all_gather(
        grid.all_gather(y.detach(), "model", 1), "data", 0).numpy()
    out[f"project-{strategy}-dx"] = grid.all_gather(xs.grad, "data",
                                                    0).numpy()
    out[f"project-{strategy}-dw"] = gather_block(ws.grad, ws.spec,
                                                 grid).numpy()
    out[f"project-{strategy}-hops"] = np.array(
        wc.coll_counts_by_op["collective-permute"])
np.savez(data.replace("case", f"out{rank}"), **out)
dist.destroy_process_group()
"""


def _moe_case(arch):
    """The port's and the reference's fp32 SMOKE configs of ``arch``
    without drops, the reference's ``init_moe`` params, and activations."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=32.0))
    rcfg = ref_get_config(arch, smoke=True)
    rcfg = dataclasses.replace(rcfg, dtype="float32", moe=dataclasses.replace(
        rcfg.moe, capacity_factor=32.0))
    params = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg, RefCtx(None),
                              dtype=jnp.float32)
    x = np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    return cfg, rcfg, params, x


def _opt():
    return ref_opt.make_optimizer(ref_opt.OptimizerConfig(
        name="adafactor", total_steps=10, warmup_steps=1))


def _step_case(arch):
    """The reference's fp32 SMOKE train state of ``arch`` and a batch,
    as numpy."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    state = ref_ts.make_train_state(jax.random.PRNGKey(0), rcfg,
                                    RefCtx(None), _opt())
    return (jax.tree.map(np.asarray, state),
            RefData(rcfg, STEP_BATCH, STEP_SEQ, seed=1).batch_at(0))


def _ring_case():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(16, 64)).astype(np.float32),
            rng.normal(size=(64, 24)).astype(np.float32))


def _wide_weight():
    """A (64, 4096) weight drawn N(0, 1/64), as the models draw theirs:
    at (16, 64) x (64, 4096) on a (2, 4) grid the ring's pipeline estimate
    beats the tuned schedule."""
    return (np.random.default_rng(2).normal(size=(64, 4096)) / 8).astype(
        np.float32)


@pytest.fixture(scope="module")
def grid8(tmp_path_factory):
    """The inputs, and every rank's outputs of one 8-process spawn."""
    tmp = tmp_path_factory.mktemp("grid8")
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 128)).astype(np.float32)
    b = rng.normal(size=(128, 96)).astype(np.float32)
    payload = {"a": a, "b": b}
    for arch in MOE_ARCHS:
        cfg, _, params, x = _moe_case(arch)
        leaves = reference_leaves(jax.tree.map(np.asarray, params), cfg)
        payload |= {f"{arch}/{k}": v for k, v in leaves.items()}
        payload[arch + "-x"] = x
    for arch in MOE_ARCHS:
        state, batch = _step_case(arch)
        payload |= {f"state-{arch}/{k}": v for k, v in tree_leaves(state)}
        payload |= {f"batch-{arch}/{k}": v for k, v in batch.items()}
    payload["ring_x"], payload["ring_w"] = _ring_case()
    payload["ring_w_wide"] = _wide_weight()
    spec = dict(axes=AXES3, k_blocks_25d=K_BLOCKS_25D,
                tuple_cases=TUPLE_CASES, moe_archs=MOE_ARCHS,
                lookaheads=RING_LOOKAHEADS)
    data = tmp / "case.npz"
    np.savez(data, spec=np.array(repr(spec)), **payload)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_PROGRAM, str(rank), str(tmp / "rdv"),
             str(data)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(8)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    outs = [dict(np.load(tmp / f"out{rank}.npz")) for rank in range(8)]
    return a, b, outs


def _hold(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


def test_every_rank_returns_the_whole_result(grid8):
    """Products are gathered on every rank, the MoE output is summed over
    the tp axis and gathered over the data axis, and every sharded result
    is gathered whole: all eight hold the same arrays."""
    _, _, outs = grid8
    for rank in range(1, 8):
        assert outs[rank].keys() == outs[0].keys()
        for key, value in outs[0].items():
            np.testing.assert_array_equal(outs[rank][key], value,
                                          err_msg=f"{key} on rank {rank}")


@pytest.mark.parametrize("k_blocks", K_BLOCKS_25D)
def test_25d_on_a_222_grid_matches_reference(grid8, k_blocks):
    a, b, outs = grid8
    cfg = ref_summa.SummaConfig(mesh=make_mesh((1, 1, 1), AXES3),
                                row_axis="data", col_axis="model",
                                strategy="taskbased", k_blocks=k_blocks)
    want = ref_summa.summa_25d_matmul(jnp.asarray(a), jnp.asarray(b), cfg)
    _hold(outs[0][f"25d-{k_blocks}"], want)
    _hold(outs[0][f"25d-{k_blocks}"], a.astype(np.float64) @ b)


@pytest.mark.parametrize("name", list(TUPLE_CASES))
def test_tuple_axes_match_reference(grid8, name):
    """Owners, gathers and scatters along tuple axes in and against the
    grid's order: the panels come from the right ranks."""
    a, b, outs = grid8
    row, col, how = TUPLE_CASES[name]
    mesh = make_mesh((1, 1, 1), AXES3)
    if how in ("A", "B"):
        want = RefDistributedMatmul(mesh, row_axis=row, col_axis=col,
                                    k_blocks=4)(jnp.asarray(a),
                                                jnp.asarray(b),
                                                stationarity=how)
    else:
        want = ref_summa.summa_matmul(
            jnp.asarray(a), jnp.asarray(b),
            ref_summa.SummaConfig(mesh=mesh, row_axis=row, col_axis=col,
                                  strategy=how, k_blocks=4))
    _hold(outs[0][name], want)
    _hold(outs[0][name], a.astype(np.float64) @ b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_matches_one_rank_route(grid8, arch):
    """Experts stored over the 4-rank ``model`` axis of a (2, 4) grid,
    each rank on its batch rows, every rank's partial output summed over
    ``model`` by ``Grid.sum``: within 1e-4 of the one-rank route, the
    port's and the reference's."""
    _, _, outs = grid8
    cfg, rcfg, params, x = _moe_case(arch)
    layer = load_leaves(moe.MoE(cfg, dtype=torch.float32, device="cpu"),
                        reference_leaves(jax.tree.map(np.asarray, params),
                                         cfg))
    local, aux = moe.moe_ffn(layer, torch.from_numpy(x), cfg,
                             ParallelCtx(None))
    want, want_aux = ref_moe.moe_ffn(params, jnp.asarray(x), rcfg,
                                     RefCtx(None))
    got = outs[0]["ep-" + arch]
    assert np.abs(got - local.numpy()).max() < 1e-4
    assert np.abs(got - np.asarray(want)).max() < 1e-4
    np.testing.assert_allclose(outs[0]["aux-" + arch], float(aux), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_gradient_matches_reference(grid8, arch):
    """The gradient through expert parallelism on the (2, 4) grid, of
    every parameter of the MoE layer and of its input, equals the
    reference's whole gradient on one device: no factor of the 4 ranks
    (the activations' gradient summed over them, each expert weight's
    block gathered from its rank, a replicated one's summed over the
    data axis)."""
    _, _, outs = grid8
    cfg, rcfg, params, x = _moe_case(arch)

    def loss(p, x):
        y, aux = ref_moe.moe_ffn(p, x, rcfg, RefCtx(None))
        return jnp.sum(y ** 2) + aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    want = reference_leaves(jax.tree.map(np.asarray, gp), cfg)
    want["x"] = np.asarray(gx)
    got = {k.split("/", 1)[1]: v for k, v in outs[0].items()
           if k.startswith(f"grad-{arch}/")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_train_step_matches_reference(grid8, arch):
    """One Adafactor step of the fp32 SMOKE model on its sharded state
    (experts over the 4-rank ``model`` axis, each rank its rows of the
    batch) equals the reference's step on one device:
    metrics at rtol 1e-4, every leaf of the new state at 1e-4 of its
    largest value."""
    _, _, outs = grid8
    state, batch = _step_case(arch)
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    fn = ref_ts.build_train_step(rcfg, RefCtx(None), _opt())
    rstate, rmetrics = jax.jit(fn)(jax.tree.map(jnp.asarray, state),
                                   jax.tree.map(jnp.asarray, batch))
    want = {k: np.asarray(v, np.float32) for k, v in tree_leaves(
        jax.tree.map(np.asarray, rstate))}
    got = {k.split("/", 1)[1]: v for k, v in outs[0].items()
           if k.startswith(f"step-{arch}/")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    for k, v in rmetrics.items():
        np.testing.assert_allclose(outs[0][f"metric-{arch}/{k}"],
                                   float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _ring_want(**kw):
    x, w = _ring_case()
    return ref_allgather(jnp.asarray(x), jnp.asarray(w),
                         mesh=make_mesh((1, 1), ("data", "model")),
                         axis="model", **kw)


@pytest.mark.parametrize("lookahead", RING_LOOKAHEADS)
def test_ring_matmul_matches_reference(grid8, lookahead):
    """``allgather_matmul`` over the 4-rank ``model`` ring at lookahead
    1, 2 and 4 (clamped to the ring), each rank's tile gathered back."""
    _, _, outs = grid8
    x, w = _ring_case()
    _hold(outs[0][f"ring-{lookahead}"], _ring_want(lookahead=lookahead))
    _hold(outs[0][f"ring-{lookahead}"], x.astype(np.float64) @ w)


def test_ring_matmul_with_batch_axes_and_gradient(grid8):
    """M sharded over ``("data", "model")`` (``project``'s route), and
    the gradient of sum(tile²) with respect to W within 1e-3 of the
    reference's, as its own test holds it."""
    _, _, outs = grid8
    x, w = _ring_case()
    _hold(outs[0]["ring-batch"], _ring_want(batch_axes=("data",)))
    mesh = make_mesh((1, 1), ("data", "model"))
    g = jax.grad(lambda w: jnp.sum(ref_allgather(
        jnp.asarray(x), w, mesh=mesh, axis="model") ** 2))(jnp.asarray(w))
    assert np.abs(outs[0]["ring-dw"] - np.asarray(g)).max() < 1e-3


@pytest.mark.parametrize("strategy", ["allgather", "auto"])
def test_project_runs_the_ring(grid8, strategy):
    """``project`` on the (2, 4) grid, given the rank's rows and its stored
    block of the weight, routes ``"allgather"`` and, for this dense
    shape, ``"auto"`` (the ring's pipeline estimate beats the tuned
    schedule) to the ring: ring hops on every rank, the reference's
    product, and the whole gradients within 1e-3."""
    from repro.core.plan import plan_matmul
    from repro.sched import abstract_summa_config, ring_makespan, tune_plan

    _, _, outs = grid8
    x, w = _ring_case()[0], _wide_weight()
    plan = tune_plan(plan_matmul(16, 64, 4096, abstract_summa_config(
        2, 4, strategy="taskbased")))
    assert ring_makespan(plan) < plan.tuned["makespan_s"]  # the ring wins
    ref = RefCtx(make_mesh((1, 1), ("data", "model")),
                 matmul_strategy=strategy)
    _hold(outs[0][f"project-{strategy}"],
          ref_project(jnp.asarray(x), jnp.asarray(w), ref))
    gx, gw = jax.grad(lambda x, w: jnp.sum(jnp.matmul(x, w) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert np.abs(outs[0][f"project-{strategy}-dx"] - gx).max() < 1e-3
    assert np.abs(outs[0][f"project-{strategy}-dw"] - gw).max() < 1e-3
    # (p - 1) hops of x, a lookahead of 2, and p - 1 more of x and of the
    # partial sums in the backward: counted in the forward only
    assert all(int(out[f"project-{strategy}-hops"]) == 3 for out in outs)
