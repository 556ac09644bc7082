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
  SMOKE MoE layers with their experts over the 4-rank ``model`` axis,
  against the one-rank route (the reference's
  ``tests/test_moe.py::test_expert_parallel_equivalence_subprocess``).

Run it alone with ``pytest tests/test_torch_grid8.py`` (~20 s).
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
from repro.models import moe as ref_moe
from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import moe
from repro_torch.models.convert import load_leaves, reference_leaves

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
from repro_torch.models.convert import load_leaves

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
for arch in spec["moe_archs"]:
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=32.0))
    leaves = {k.split("/", 1)[1]: case[k] for k in case.files
              if k.startswith(arch + "/")}
    layer = load_leaves(moe.MoE(cfg, ep=4, dtype=torch.float32, device="cpu"),
                        leaves)
    y, aux = moe.moe_ffn(layer, torch.from_numpy(case[arch + "-x"]), cfg, ctx)
    out["ep-" + arch], out["aux-" + arch] = y.numpy(), aux.numpy()
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
    spec = dict(axes=AXES3, k_blocks_25d=K_BLOCKS_25D,
                tuple_cases=TUPLE_CASES, moe_archs=MOE_ARCHS)
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
    """Products are gathered on every rank and the MoE output is summed
    over the tp axis on every rank: all eight hold the same arrays."""
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
    """Experts over the 4-rank ``model`` axis of a (2, 4) grid, every
    rank's partial output summed by ``Grid.all_reduce``: within 1e-4 of
    the one-rank route, the port's and the reference's."""
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
