"""A summa train step on a 2x2 grid of gloo processes against one rank.

Four processes form the ``(data, model)`` grid; each holds its blocks
of the train state (``make_train_state`` shards it) and runs
``build_train_step`` on its rows of the batch under
``matmul_strategy="summa"``: every FFN projection, and both products of
its backward, run the paper's engine across the four ranks.  Every
rank's new state, gathered whole (llama3.2-1b SMOKE in fp32, Adafactor,
two microbatches), must equal the same step on ``Grid.local``'s one rank
within 1e-5 of each leaf's largest value, with equal metrics.  (AdamW's
first step moves each parameter by about ``lr·g/(|g|+eps)``, a sign for
all but the smallest gradients, so an element whose gradient is near
``eps`` moves by up to ``lr`` on a change in the last bits of its sum;
Adafactor's update is smooth in the gradient.)  And ``launch.train.main
--dp 2 --tp 2 --matmul-strategy summa`` on the grid must give the losses
of the one-rank run: in fp32 (the config's dtype replaced in the
process) within rtol 1e-4, in the config's bf16 within rtol 1e-3.  A
sharded bf16 step rounds each rank's partial gradient (over its rows,
or its heads' and hidden columns' part of an activation's gradient) to
bf16 before the ranks' sum, as the reference's reduce-scatter of bf16
gradients does; summing those in fp32 changes no loss here (the sum of
two bf16 values rounds once either way).  The reference's own
``repro.launch.train`` with these flags on a 2x2, 2x1 and 1x2 host mesh
leaves its one-device run by up to 6.3e-4 (relative, the third loss;
both strategies), the port's 2x2 run its one rank's by 5.0e-4.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from conftest import SRC
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.train import train_step as ts
from repro_torch.train.data import SyntheticData
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves

_RANK_PROGRAM = r"""
import dataclasses
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.train import train_step as ts
from repro_torch.train.data import SyntheticData
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves

torch.set_num_threads(1)
rank, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
grid = Grid.from_process_group(2, 2, device="cpu")
cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                          dtype="float32")
opt = make_optimizer(OptimizerConfig(name="adafactor", total_steps=10,
                                     warmup_steps=1))
ctx = ParallelCtx(grid, matmul_strategy="summa")
state = ts.make_train_state(cfg, ctx, opt, device="cpu",
                            generator=torch.Generator().manual_seed(0))
batch = SyntheticData(cfg, 4, 32, seed=1).batch_at(0)
state, metrics = ts.build_train_step(cfg, ctx, opt, microbatches=2)(state,
                                                                     batch)
res = {f"state/{k}": v for k, v in leaves(train_state_to_numpy(state, ctx))}
res.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
argv = ["--device", "cpu", "--smoke", "--steps", "3", "--global-batch",
        "2", "--seq", "32", "--dp", "2", "--tp", "2", "--matmul-strategy",
        "summa", "--log-every", "100"]
res["losses"] = np.array(launch_train.main(argv))
launch_train.get_config = lambda *a, **k: dataclasses.replace(
    get_config(*a, **k), dtype="float32")
res["losses-f32"] = np.array(launch_train.main(argv))
np.savez(out, **res)
dist.destroy_process_group()
"""


def test_summa_train_step_on_2x2_gloo_grid(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              dtype="float32")
    opt = make_optimizer(OptimizerConfig(name="adafactor", total_steps=10,
                                     warmup_steps=1))
    ctx = ParallelCtx(Grid.local("cpu"), matmul_strategy="summa")
    state = ts.make_train_state(cfg, ctx, opt, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    batch = SyntheticData(cfg, 4, 32, seed=1).batch_at(0)
    state, metrics = ts.build_train_step(cfg, ctx, opt, microbatches=2)(
        state, batch)
    want = dict(leaves(train_state_to_numpy(state)))
    argv = ["--device", "cpu", "--smoke", "--steps", "3", "--global-batch",
            "2", "--seq", "32", "--matmul-strategy", "summa", "--log-every",
            "100"]
    want_losses = launch_train.main(argv)
    monkeypatch.setattr(launch_train, "get_config",
                        lambda *a, **k: dataclasses.replace(
                            get_config(*a, **k), dtype="float32"))
    want_f32 = launch_train.main(argv)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(rank),
         str(tmp_path / "rdv"), str(tmp_path / f"out{rank}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    for rank in range(4):
        out = np.load(tmp_path / f"out{rank}.npz")
        for k, v in metrics.items():
            np.testing.assert_allclose(out[f"metric/{k}"], v.numpy(),
                                       rtol=1e-5, err_msg=k)
        for k, w in want.items():
            np.testing.assert_allclose(out[f"state/{k}"], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(out["losses-f32"], want_f32, rtol=1e-4)
        np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-3)
