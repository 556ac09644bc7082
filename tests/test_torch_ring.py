"""The ring collective matmul on a 2x2 grid of gloo processes, against
the JAX package.

``dist.collective_matmul.allgather_matmul`` is the reference's
``shard_map`` program as one rank's program: the activation chunks travel
the ``model`` ring (``Grid.ring_shift``) while each rank multiplies the
one in hand.  One spawn of four CPU processes runs the reference's
``tests/test_dist.py`` ``ALLGATHER_MM_CODE`` cases on a (2, 2) grid —
lookahead 1, 2 and 4 (clamped to the ring of two), M sharded over
``("data", "model")``, the weight's gradient — and ``project`` under
``"allgather"`` and ``"auto"`` on the rank's rows and its stored block of
the weight (``dist.partitioning.shard_params``), each tile gathered back
to whole on every rank.  Products are held with ``ORACLE_ATOL``/``ORACLE_RTOL`` against
the reference on a one-device mesh of the same axes, gradients within
1e-3 as the reference's own test holds them.  The (2, 4) cases run in
``tests/test_torch_grid8.py``'s spawn.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import ORACLE_ATOL, ORACLE_RTOL, SRC
from repro.core.plan import plan_matmul
from repro.dist.collective_matmul import allgather_matmul as ref_allgather
from repro.dist.collective_matmul import project as ref_project
from repro.dist.context import ParallelCtx as RefCtx
from repro.launch.mesh import make_mesh
from repro.sched import abstract_summa_config, ring_makespan, tune_plan

LOOKAHEADS = (1, 2, 4)
STRATEGIES = ("allgather", "auto")

_RANK_PROGRAM = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.analysis.cost import analyze_step
from repro_torch.core import Grid
from repro_torch.dist.collective_matmul import allgather_matmul, project
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import gather_block, shard_params
from repro_torch.train.train_step import sync_grads

rank, rdv, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
torch.set_num_threads(1)
case = np.load(data)
x, w, w_wide = case["x"], case["w"], case["w_wide"]
grid = Grid.from_process_group(2, 2, device="cpu")
me = grid.axis_index("model")
w_loc = torch.from_numpy(np.ascontiguousarray(np.split(w, 2, axis=1)[me]))
x_model = torch.from_numpy(np.split(x, 2)[me])
out = {}
for la in case["lookaheads"]:
    tile = allgather_matmul(x_model, w_loc, grid=grid, axis="model",
                            lookahead=int(la))
    out[f"ring-{la}"] = grid.all_gather(tile, "model", 1).numpy()
x_rows = torch.from_numpy(np.split(x, 4)[grid.axis_index(("data", "model"))])
x_rows.requires_grad_(True)
w_grad = w_loc.clone().requires_grad_(True)
tile = allgather_matmul(x_rows, w_grad, grid=grid, axis="model",
                        batch_axes=("data",))
(tile ** 2).sum().backward()
out["ring-batch"] = grid.all_gather(grid.all_gather(tile.detach(), "model", 1),
                                    "data", 0).numpy()
out["ring-batch-dw"] = grid.all_gather(w_grad.grad, "model", 1).numpy()
out["ring-batch-dx"] = grid.all_gather(x_rows.grad, ("data", "model"),
                                       0).numpy()
for strategy in ("allgather", "auto"):
    # the rank's rows, and its block of an FFN kernel ("data", "model")
    xs = torch.from_numpy(np.split(x, 2)[grid.axis_index("data")])
    xs.requires_grad_(True)
    holder = torch.nn.Module()
    holder.w = torch.nn.Parameter(torch.from_numpy(w_wide))
    ws = shard_params(holder, grid).w
    ctx = ParallelCtx(grid, matmul_strategy=strategy)
    y, wc, _ = analyze_step(project, xs, ws, ctx)
    (y ** 2).sum().backward()
    sync_grads(holder, ctx)
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


def _case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    # drawn N(0, 1/64) as the models draw theirs; at (16, 64) x (64, 4096)
    # the ring's pipeline estimate beats the tuned schedule on (2, 2)
    w_wide = (np.random.default_rng(2).normal(size=(64, 4096)) / 8).astype(
        np.float32)
    return x, w, w_wide


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    """Every rank's outputs of one 4-process spawn."""
    tmp = tmp_path_factory.mktemp("ring4")
    x, w, w_wide = _case()
    data = tmp / "case.npz"
    np.savez(data, x=x, w=w, w_wide=w_wide, lookaheads=np.array(LOOKAHEADS))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(rank), str(tmp / "rdv"),
         str(data)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [dict(np.load(tmp / f"out{rank}.npz")) for rank in range(4)]


def _hold(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def test_every_rank_holds_the_whole_result(ring4):
    for out in ring4[1:]:
        assert out.keys() == ring4[0].keys()
        for key, value in ring4[0].items():
            np.testing.assert_array_equal(out[key], value, err_msg=key)


@pytest.mark.parametrize("lookahead", LOOKAHEADS)
def test_ring_matmul_matches_reference(ring4, lookahead):
    x, w, _ = _case()
    want = ref_allgather(jnp.asarray(x), jnp.asarray(w), mesh=_mesh(),
                         axis="model", lookahead=lookahead)
    _hold(ring4[0][f"ring-{lookahead}"], want)
    _hold(ring4[0][f"ring-{lookahead}"], x.astype(np.float64) @ w)


def test_ring_matmul_with_batch_axes_and_gradients(ring4):
    """M over ``("data", "model")``: the product, dW (the ring over x's
    chunks, summed over ``data``) and dX (the ring reduce-scatter) of
    sum(tile²), against the reference's gradients."""
    x, w, _ = _case()
    kw = dict(mesh=_mesh(), axis="model", batch_axes=("data",))
    _hold(ring4[0]["ring-batch"],
          ref_allgather(jnp.asarray(x), jnp.asarray(w), **kw))
    gx, gw = jax.grad(lambda x, w: jnp.sum(ref_allgather(x, w, **kw) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert np.abs(ring4[0]["ring-batch-dw"] - np.asarray(gw)).max() < 1e-3
    assert np.abs(ring4[0]["ring-batch-dx"] - np.asarray(gx)).max() < 1e-3


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_project_runs_the_ring(ring4, strategy):
    """``project``, given the rank's rows and its stored block of the
    weight, routes ``"allgather"`` and, at this shape, ``"auto"`` to the
    ring (one hop in the forward on a ring of two), with the reference's
    product and gradients."""
    x, _, w = _case()
    plan = tune_plan(plan_matmul(16, 64, 4096, abstract_summa_config(
        2, 2, strategy="taskbased")))
    assert ring_makespan(plan) < plan.tuned["makespan_s"]
    ref = RefCtx(_mesh(), matmul_strategy=strategy)
    _hold(ring4[0][f"project-{strategy}"],
          ref_project(jnp.asarray(x), jnp.asarray(w), ref))
    gx, gw = jax.grad(lambda x, w: jnp.sum(jnp.matmul(x, w) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert np.abs(ring4[0][f"project-{strategy}-dx"] - gx).max() < 1e-3
    assert np.abs(ring4[0][f"project-{strategy}-dw"] - gw).max() < 1e-3
    assert all(int(out[f"project-{strategy}-hops"]) == 1 for out in ring4)
