"""Sharded per-rank programs on gloo grids against the JAX package.

One spawn of a 2x2 ``(data, model)`` grid (four processes), one of a 2x4
grid (eight) and one of a 2x1 grid (two).  Each rank holds only its
blocks (``dist.partitioning.shard_params``, the train state through
``train.train_step``), runs its rows of the global batch and its heads,
hidden columns, experts and vocab, and its whole results are gathered
for the test.  Every case is held against the reference's one-device
result on the same numpy inputs (the reference's ``init_model`` and
train states, fp32 SMOKE configs; MoE configs without capacity drops):

* the forward of all ten archs on 2x2; llama3.2-1b on 2x4, where tp = 4
  leaves its 2 kv heads whole (each rank keeps those its q heads read),
  and a vocab of 514, which does not divide tp and stays whole;
* ``loss_fn`` and every parameter's gradient for llama3.2-1b,
  mixtral-8x7b, recurrentgemma-9b and xlstm-1.3b on 2x2, and the two
  2x4 cases; llama3.2-1b's with the FFN projections on ``project``'s
  ring (``"allgather"``) and SUMMA routes;
* one train step of llama3.2-1b under AdamW, Adafactor, AdamW with
  ``zero1`` and Adafactor over 2 microbatches on 2x2, and of mixtral-8x7b
  on 2x4;
* prefill plus 4 decode steps of llama3.2-1b on 2x2 (dp = 2; tp = 2,
  whose KV caches hold an S-shard each) and the ``Scheduler`` with a
  dp = 2 slot pool (greedy tokens equal to the reference scheduler's);
* a checkpoint saved on 2x2 after two steps and restored on 1x1 (this
  process) and on 2x1: the next two losses equal the uninterrupted 2x2
  run's, and the 2x2 run's those of the reference;
* the paged ``Scheduler`` on 2x1 (dp = 2, tp = 1): every request's greedy
  tokens equal the reference's paged scheduler's and the port's dense
  scheduler's on the same grid, each rank's pools have the shape of the
  reference's ``paged_init_cache`` and its page table is the reference
  allocator's;
* each rank's held bytes equal its spec's share (``param_shardings``),
  ``gather_params`` gives the whole parameters back bitwise, and rank
  0's count of a train step on the 2x2 grid equals, to the FLOP
  and the byte, the dry run's count of rank 0's program on a ``meta``
  counting grid.

Tolerances are the reference's: fp32 forwards, gradients and train steps
at 1e-4 of each leaf's largest value (xlstm-1.3b's gradient at 1e-2, as
``tests/test_torch_train.py``: the reference's own fp32 gradient moves
by 2.2e-3 on a one-ulp nudge of the parameters); serving logits at
1e-4 of the largest.  Run it alone with ``pytest tests/test_torch_shard.py``
(~150 s).
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

from conftest import SRC
from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.serve import pages as ref_pages
from repro.serve import scheduler as ref_sched
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.data import SyntheticData as RefData
from repro.train.data import mrope_positions
from repro_torch.analysis import cost
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import param_shardings
from repro_torch.launch import dryrun
from repro_torch.models.convert import reference_leaves
from repro_torch.models.model import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves as tree_leaves
from repro_torch.train.tree import unflatten

B, S = 4, 16
GRAD_ARCHS = ("llama3.2-1b", "mixtral-8x7b", "recurrentgemma-9b",
              "xlstm-1.3b")
#: name -> (arch, optimizer, zero1, microbatches) of the 2x2 train steps
STEPS22 = {
    "adamw": ("llama3.2-1b", "adamw", False, 1),
    "adafactor": ("llama3.2-1b", "adafactor", False, 1),
    "zero1": ("llama3.2-1b", "adamw", True, 1),
    "microbatches": ("llama3.2-1b", "adafactor", False, 2),
}
STEPS24 = {"mixtral": ("mixtral-8x7b", "adafactor", False, 1)}
#: the FFN projections through ``project``'s ring and SUMMA routes on
#: the rank's shards (llama3.2-1b's loss and gradients on 2x2)
STRATEGIES = ("allgather", "summa")
#: the 2x4 cases: llama3.2-1b SMOKE (kv heads whole at tp = 4) and a
#: vocab that does not divide tp
CASES24 = ("llama3.2-1b", "vocab514")
SERVE_LEN, SERVE_PROMPT, SERVE_STEPS = 24, 16, 4
SLOTS, SCHED_MAX_LEN = 4, 32
#: the 2x1 paged and dense schedulers' trace (the reference's ragged one)
PAGED_REQUESTS = 8

_RANK_PROGRAM = r"""
import copy
import dataclasses
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.analysis import cost
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import (gather_block, gather_params,
                                           spec_of)
from repro_torch.launch.serve import param_bytes
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference,
                                        train_state_to_numpy)
from repro_torch.models.model import forward, loss_fn, whole_logits
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Scheduler, ragged_trace
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves, unflatten

rank, world, rdv, data = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=world)
torch.set_num_threads(1)
case = np.load(data)
spec = eval(str(case["spec"]))
grid = Grid.from_process_group(*spec["sizes"], device="cpu")
ctx = ParallelCtx(grid)
out = {}


def config(name):
    arch = "llama3.2-1b" if name == "vocab514" else name
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if name == "vocab514":
        cfg = dataclasses.replace(cfg, vocab_size=514)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=32.0))
    return cfg


def subtree(prefix):
    n = len(prefix) + 1
    return {k[n:]: case[k] for k in case.files if k.startswith(prefix + "/")}


def model_of(name, cfg):
    model = params_from_reference(unflatten(subtree("params-" + name)), cfg,
                                  "cpu", ep=ctx.tp_size)
    return ts.shard_model(model, ctx)


def inputs_of(name):
    return {k: torch.from_numpy(v) for k, v in subtree("in-" + name).items()}


for name in spec["forward"]:
    cfg = config(name)
    model = model_of(name, cfg)
    out[f"held-{name}"] = np.array(param_bytes(model, grid)[1])
    whole = gather_params(copy.deepcopy(model), grid)
    want = params_from_reference(unflatten(subtree("params-" + name)), cfg,
                                 "cpu", ep=ctx.tp_size)
    out[f"unshard-{name}"] = np.array(all(
        torch.equal(a, b) and spec_of(a) is None
        for a, b in zip(whole.parameters(), want.parameters())))
    batch = inputs_of(name)
    with torch.no_grad():
        logits, aux = forward(model, batch, cfg, ctx)
    rows = ctx.splits_batch(batch["labels"].shape[0])
    out[f"fwd-{name}"] = whole_logits(model, logits, cfg, ctx, rows).numpy()
    if name in spec["grad"]:
        model.requires_grad_(True)
        loss, metrics = loss_fn(model, batch, cfg, ctx)
        loss.backward()
        ts.sync_grads(model, ctx)
        out[f"loss-{name}"] = loss.detach().numpy()
        for pname, p in model.named_parameters():
            out[f"grad-{name}/{pname}"] = gather_block(
                p.grad, spec_of(p), grid).numpy()

for strategy in spec["strategies"]:  # project's ring and SUMMA routes
    cfg = config("llama3.2-1b")
    c = ParallelCtx(grid, matmul_strategy=strategy)
    model = model_of("llama3.2-1b", cfg).requires_grad_(True)
    loss, metrics = loss_fn(model, inputs_of("llama3.2-1b"), cfg, c)
    loss.backward()
    ts.sync_grads(model, c)
    out[f"loss-{strategy}"] = loss.detach().numpy()
    for pname, p in model.named_parameters():
        out[f"grad-{strategy}/{pname}"] = gather_block(
            p.grad, spec_of(p), grid).numpy()

for name, (arch, opt_name, zero1, mb) in spec["steps"].items():
    cfg = config(arch)
    c = ParallelCtx(grid, zero1=zero1)
    opt = make_optimizer(OptimizerConfig(name=opt_name, total_steps=10,
                                         warmup_steps=1))
    state = train_state_from_reference(
        unflatten(subtree("state-" + arch + "-" + opt_name)), cfg, "cpu",
        ep=c.tp_size, ctx=c)
    batch = inputs_of(arch)
    state, metrics = ts.build_train_step(cfg, c, opt, microbatches=mb)(
        state, batch)
    for k, v in leaves(train_state_to_numpy(state, c)):
        out[f"step-{name}/{k}"] = v
    out[f"step-{name}-loss"] = metrics["loss"].numpy()

if spec["serve"]:
    cfg = config("llama3.2-1b")
    model = model_of("llama3.2-1b", cfg)
    toks = torch.from_numpy(case["serve-tokens"])
    with torch.inference_mode():
        logits, cache = engine.prefill(
            model, {"tokens": toks[:, :spec["prompt"]]}, cfg, ctx,
            max_len=spec["max_len"])
        steps = [logits]
        for t in range(spec["decode"]):
            logits, cache = engine.decode_step(
                model, cache, toks[:, spec["prompt"] + t], cfg, ctx)
            steps.append(logits)
        out["serve"] = torch.stack(steps).numpy()
        out["serve-k"] = np.array(cache["units"]["b0"]["k"].shape)
        res = Scheduler(model, cfg, ctx, n_slots=spec["slots"],
                        max_len=spec["sched_max_len"]).run(ragged_trace(
            8, prompt_lens=(6, 10), gen_lens=(3, 8), vocab=cfg.vocab_size))
    for rid, toks_out in res["outputs"].items():
        out[f"sched-{rid}"] = np.array(toks_out)

if spec["paged"]:
    cfg = config("llama3.2-1b")
    model = model_of("llama3.2-1b", cfg)
    trace = dict(prompt_lens=(6, 10), gen_lens=(3, 8),
                 vocab=cfg.vocab_size)
    with torch.inference_mode():
        for backend in ("dense", "paged"):
            sched = Scheduler(model, cfg, ctx, n_slots=spec["slots"],
                              max_len=spec["sched_max_len"],
                              backend=backend)
            if backend == "paged":  # the page table after admission
                sched.run(ragged_trace(spec["slots"], **trace),
                          max_steps=1)
                out["paged-table"] = sched.alloc._table.copy()
                for key, leaf in leaves(sched.cache):
                    out[f"paged-shape/{key}"] = np.array(leaf.shape)
                sched = Scheduler(model, cfg, ctx, n_slots=spec["slots"],
                                  max_len=spec["sched_max_len"],
                                  backend=backend)
            res = sched.run(ragged_trace(spec["n_requests"], **trace))
            for rid, toks_out in res["outputs"].items():
                out[f"{backend}-{rid}"] = np.array(toks_out)

if spec["ckpt_save"] or spec["ckpt_restore"]:
    cfg = config("llama3.2-1b")
    opt = make_optimizer(OptimizerConfig(name="adamw", total_steps=10,
                                         warmup_steps=1))
    step_fn = ts.build_train_step(cfg, ctx, opt)
    batches = [{k[2:]: torch.from_numpy(case[f"ckpt-batch{i}/{k}"])
                for k in ("b/tokens", "b/labels")} for i in range(4)]
    if spec["ckpt_save"]:
        state = train_state_from_reference(
            unflatten(subtree("state-llama3.2-1b-adamw")), cfg, "cpu",
            ctx=ctx)
        losses = []
        for i in range(4):
            state, metrics = step_fn(state, batches[i])
            losses.append(float(metrics["loss"]))
            if i == 1:
                tree = ts.state_tree(state, ctx)
                if rank == 0:
                    ckpt.save_checkpoint(spec["ckpt_dir"], 2, tree)
                dist.barrier()
        out["ckpt-losses"] = np.array(losses)
    else:
        state = ts.make_train_state(cfg, ctx, opt, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
        tree = ckpt.restore_checkpoint(
            spec["ckpt_dir"], 2, ts.state_target(state), device="cpu",
            shardings=ts.state_shardings(state, ctx), grid=grid)
        ts.load_state_tree(state, tree)
        out["ckpt-losses"] = np.array(
            [float(step_fn(state, batches[i])[1]["loss"]) for i in (2, 3)])

if spec["count"]:
    cfg = config("llama3.2-1b")
    opt = make_optimizer(OptimizerConfig(name="adamw"))
    state = ts.make_train_state(cfg, ctx, opt, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    _, wc, mem = cost.analyze_step(
        ts.build_train_step(cfg, ctx, opt), state, inputs_of("llama3.2-1b"),
        counter=cost.CostCounter("cpu"))
    out["count"] = np.array([wc.flops, wc.hbm_bytes, wc.coll_bytes,
                             mem.peak_live_bytes])
np.savez(data.replace("case", f"out{rank}"), **out)
dist.destroy_process_group()
"""


def _cfgs(name):
    arch = "llama3.2-1b" if name == "vocab514" else name
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    if name == "vocab514":
        cfg = dataclasses.replace(cfg, vocab_size=514)
        rcfg = dataclasses.replace(rcfg, vocab_size=514)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=32.0))
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=32.0))
    return cfg, rcfg


def _inputs(cfg, seed):
    """A batch of B rows: tokens and/or embeddings (M-RoPE positions for
    the VLM) and labels, some masked."""
    rng = np.random.default_rng(seed)
    out = {}
    s_text = S
    if cfg.family == "vlm":
        s_vis = S // 4
        s_text = S - s_vis
        out["embeds"] = rng.normal(size=(B, s_vis, cfg.d_model))
        out["positions"] = mrope_positions(B, s_vis, s_text)
    elif not cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model))
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, size=(B, s_text))
    if "embeds" in out:
        out["embeds"] = out["embeds"].astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, s_text))
    labels[0, :5] = -1
    out["labels"] = labels
    return out


def _ref_opt(name):
    return ref_opt.make_optimizer(ref_opt.OptimizerConfig(
        name=name, total_steps=10, warmup_steps=1))


class _Memo:
    """The reference's params, inputs and results, built once."""

    def __init__(self):
        self.cases = {}

    def case(self, name):
        if name not in self.cases:
            cfg, rcfg = _cfgs(name)
            params = ref_model.init_model(jax.random.PRNGKey(0), rcfg,
                                          RefCtx(None))
            self.cases[name] = dict(
                cfg=cfg, rcfg=rcfg, params=params,
                np_params=jax.tree.map(np.asarray, params),
                inputs=_inputs(cfg, len(name)))
        return self.cases[name]

    def state(self, arch, opt):
        key = ("state", arch, opt)
        if key not in self.cases:
            c = self.case(arch)
            self.cases[key] = ref_ts.make_train_state(
                jax.random.PRNGKey(0), c["rcfg"], RefCtx(None), _ref_opt(opt))
        return self.cases[key]


MEMO = _Memo()


def _payload(names, steps):
    out = {}
    for name in names:
        c = MEMO.case(name)
        out |= {f"params-{name}/{k}": v
                for k, v in tree_leaves(c["np_params"])}
        out |= {f"in-{name}/{k}": v for k, v in c["inputs"].items()}
    for arch, opt, _, _ in steps.values():
        state = jax.tree.map(np.asarray, MEMO.state(arch, opt))
        out |= {f"state-{arch}-{opt}/{k}": v for k, v in tree_leaves(state)}
    return out


def _serve_tokens():
    return np.random.default_rng(5).integers(
        0, 512, size=(B, SERVE_PROMPT + SERVE_STEPS))


def _ckpt_batches():
    rcfg = _cfgs("llama3.2-1b")[1]
    data = RefData(rcfg, B, S, seed=3)
    return [data.batch_at(i) for i in range(4)]


def _spawn(tmp, sizes, payload, spec, timeout=300):
    world = int(np.prod(sizes))
    data = tmp / "case.npz"
    np.savez(data, spec=np.array(repr(dict(spec, sizes=sizes))), **payload)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(rank), str(world),
         str(tmp / "rdv"), str(data)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [dict(np.load(tmp / f"out{rank}.npz")) for rank in range(world)]


_NO_SPEC = dict(forward=(), grad=(), strategies=(), steps={}, serve=False,
                ckpt_save=False, ckpt_restore=False, count=False, ckpt_dir="",
                paged=False)


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid22")
    payload = _payload(REF_ARCH_IDS, STEPS22)
    payload["serve-tokens"] = _serve_tokens()
    for i, batch in enumerate(_ckpt_batches()):
        payload |= {f"ckpt-batch{i}/b/{k}": v for k, v in batch.items()}
    spec = dict(_NO_SPEC, forward=tuple(REF_ARCH_IDS), grad=GRAD_ARCHS,
                strategies=STRATEGIES, steps=STEPS22, serve=True, ckpt_save=True, count=True,
                ckpt_dir=str(tmp / "ckpt"), prompt=SERVE_PROMPT,
                decode=SERVE_STEPS, max_len=SERVE_LEN, slots=SLOTS,
                sched_max_len=SCHED_MAX_LEN)
    return tmp, _spawn(tmp, (2, 2), payload, spec)


@pytest.fixture(scope="module")
def grid24(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid24")
    spec = dict(_NO_SPEC, forward=CASES24, grad=CASES24, steps=STEPS24)
    return _spawn(tmp, (2, 4), _payload(CASES24 + ("mixtral-8x7b",),
                                        STEPS24), spec)


@pytest.fixture(scope="module")
def grid21(grid22, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid21")
    payload = _payload(("llama3.2-1b",), {})
    for i, batch in enumerate(_ckpt_batches()):
        payload |= {f"ckpt-batch{i}/b/{k}": v for k, v in batch.items()}
    spec = dict(_NO_SPEC, ckpt_restore=True, ckpt_dir=str(grid22[0] / "ckpt"),
                paged=True, slots=SLOTS, sched_max_len=SCHED_MAX_LEN,
                n_requests=PAGED_REQUESTS)
    return _spawn(tmp, (2, 1), payload, spec)


def _hold(got, want, tol=1e-4, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _ref_forward(name):
    c = MEMO.case(name)
    batch = {k: jnp.asarray(v) for k, v in c["inputs"].items()
             if k != "labels"}
    return ref_model.forward(c["params"], batch, c["rcfg"], RefCtx(None))[0]


def _ref_grads(name):
    c = MEMO.case(name)
    batch = {k: jnp.asarray(v) for k, v in c["inputs"].items()}

    def loss(p):
        return ref_model.loss_fn(p, batch, c["rcfg"], RefCtx(None))[0]

    value, grads = jax.value_and_grad(loss)(c["params"])
    return value, reference_leaves(jax.tree.map(np.asarray, grads), c["cfg"])


def test_every_rank_gathers_the_same_results(grid22, grid24):
    for outs in (grid22[1], grid24):
        for rank, out in enumerate(outs[1:], 1):
            for key, value in outs[0].items():
                if key.startswith("held-") or key == "count":
                    continue  # a rank's own bytes and count
                np.testing.assert_array_equal(out[key], value,
                                              err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_forward_on_2x2_matches_reference(grid22, arch):
    _hold(grid22[1][0][f"fwd-{arch}"], _ref_forward(arch), what=arch)


@pytest.mark.parametrize("name", CASES24)
def test_forward_on_2x4_matches_reference(grid24, name):
    """tp = 4: llama's 2 kv heads whole, each rank keeping those its q
    heads read; a vocab of 514 whole on every rank."""
    _hold(grid24[0][f"fwd-{name}"], _ref_forward(name), what=name)


def _check_grads(out, name, key=None):
    key = key or name
    value, want = _ref_grads(name)
    np.testing.assert_allclose(out[f"loss-{key}"], value, rtol=1e-5)
    tol = 1e-2 if name == "xlstm-1.3b" else 1e-4
    got = {k.split("/", 1)[1]: v for k, v in out.items()
           if k.startswith(f"grad-{key}/")}
    assert set(got) == set(want)
    for pname, w in want.items():
        _hold(got[pname], w, tol, f"{name} {pname}")


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_on_2x2_match_reference(grid22, arch):
    _check_grads(grid22[1][0], arch)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_project_routes_on_2x2_match_reference(grid22, strategy):
    """The FFN projections on the ring (the rank's rows round the TP ring
    against its columns) and on SUMMA over the rank's tiles (the stored
    block as B): llama3.2-1b's loss and every gradient."""
    _check_grads(grid22[1][0], "llama3.2-1b", strategy)


@pytest.mark.parametrize("name", CASES24)
def test_loss_and_gradients_on_2x4_match_reference(grid24, name):
    _check_grads(grid24[0], name)


def _check_step(out, name, arch, opt, mb):
    c = MEMO.case(arch)
    batch = {k: jnp.asarray(v) for k, v in c["inputs"].items()}
    step = ref_ts.build_train_step(c["rcfg"], RefCtx(None), _ref_opt(opt),
                                   microbatches=mb)
    state, metrics = jax.jit(step)(MEMO.state(arch, opt), batch)
    np.testing.assert_allclose(out[f"step-{name}-loss"], metrics["loss"],
                               rtol=1e-5)
    want = dict(tree_leaves(jax.tree.map(np.asarray, state)))
    got = {k.split("/", 1)[1]: v for k, v in out.items()
           if k.startswith(f"step-{name}/")}
    assert set(got) == set(want)
    for k, w in want.items():
        _hold(got[k], w, what=f"{name} {k}")


@pytest.mark.parametrize("name", STEPS22)
def test_train_step_on_2x2_matches_reference(grid22, name):
    arch, opt, _, mb = STEPS22[name]
    _check_step(grid22[1][0], name, arch, opt, mb)


@pytest.mark.parametrize("name", STEPS24)
def test_train_step_on_2x4_matches_reference(grid24, name):
    arch, opt, _, mb = STEPS24[name]
    _check_step(grid24[0], name, arch, opt, mb)


def test_prefill_and_decode_on_2x2_match_reference(grid22):
    """dp = 2 (each rank's rows of the cache) and tp = 2 (its S-shard of
    each KV leaf): the logits of the prefill and 4 decode steps."""
    c = MEMO.case("llama3.2-1b")
    toks = jnp.asarray(_serve_tokens())
    logits, cache = ref_engine.prefill(
        c["params"], {"tokens": toks[:, :SERVE_PROMPT]}, c["rcfg"],
        RefCtx(None), max_len=SERVE_LEN)
    want = [logits]
    for t in range(SERVE_STEPS):
        logits, cache = ref_engine.decode_step(
            c["params"], cache, toks[:, SERVE_PROMPT + t], c["rcfg"],
            RefCtx(None))
        want.append(logits)
    out = grid22[1][0]
    _hold(out["serve"], np.stack(want))
    # (U, B, Hkv, S, Dh): this rank's rows and S-shard
    assert tuple(out["serve-k"]) == (c["cfg"].units, B // 2, 2,
                                     SERVE_LEN // 2, 8)


def test_scheduler_with_a_dp2_pool_matches_reference(grid22):
    c = MEMO.case("llama3.2-1b")
    ref = ref_sched.Scheduler(
        c["params"], c["rcfg"], RefCtx(None), n_slots=SLOTS,
        max_len=SCHED_MAX_LEN).run(ref_sched.ragged_trace(
            8, prompt_lens=(6, 10), gen_lens=(3, 8),
            vocab=c["rcfg"].vocab_size))
    out = grid22[1][0]
    for rid, toks in ref["outputs"].items():
        assert list(out[f"sched-{rid}"]) == list(toks), rid


def _ref_paged(n_requests, max_steps=100_000):
    c = MEMO.case("llama3.2-1b")
    sched = ref_sched.Scheduler(
        c["params"], c["rcfg"], RefCtx(None), n_slots=SLOTS,
        max_len=SCHED_MAX_LEN, backend="paged")
    res = sched.run(ref_sched.ragged_trace(
        n_requests, prompt_lens=(6, 10), gen_lens=(3, 8),
        vocab=c["rcfg"].vocab_size), max_steps=max_steps)
    return sched, res


def test_paged_scheduler_on_2x1_matches_reference(grid21):
    """dp = 2, tp = 1: every rank's greedy tokens equal the reference's
    paged scheduler's (one device, as ``tests/test_scheduler.py`` runs
    it) and the port's dense scheduler's on the same grid."""
    _, ref = _ref_paged(PAGED_REQUESTS)
    assert len(ref["outputs"]) == PAGED_REQUESTS
    for out in grid21:
        for rid, toks in ref["outputs"].items():
            assert list(out[f"paged-{rid}"]) == list(toks), rid
            assert list(out[f"dense-{rid}"]) == list(toks), rid


def test_paged_pool_and_table_on_2x1_are_the_references(grid21):
    """Each rank's KV pools have the shape of the reference's
    ``paged_init_cache`` (replicated over dp, the page axis whole), its
    per-slot leaves its rows of the pool, and the page table after the
    first step equals the reference allocator's on every rank."""
    c = MEMO.case("llama3.2-1b")
    sched, _ = _ref_paged(SLOTS, max_steps=1)
    max_pages = -(-SCHED_MAX_LEN // 8)
    shapes = jax.eval_shape(lambda: ref_pages.paged_init_cache(
        c["rcfg"], SLOTS, SLOTS * max_pages + 1, 8, RefCtx(None)))
    kv = 0
    for out in grid21:
        np.testing.assert_array_equal(out["paged-table"],
                                      np.asarray(sched.alloc._table))
    for key, want in tree_leaves(shapes):
        leaf = key.rsplit("/", 1)[-1]
        for out in grid21:
            got = tuple(out[f"paged-shape/{key}"])
            if leaf in ("k", "v"):
                kv += 1
                assert got == tuple(want.shape), key
            else:  # this rank's rows of the slot pool
                ax = 1 if key.startswith("units") else 0
                exp = list(want.shape)
                exp[ax] //= 2
                assert got == tuple(exp), key
    assert kv > 0


def test_checkpoint_restores_on_other_grids(grid22, grid21):
    """Saved on 2x2 after two AdamW steps (whole leaves, rank 0 writing):
    restored on 1x1 here and on 2x1, the next two losses equal the
    uninterrupted 2x2 run's; the 2x2 run's four equal the reference's."""
    tmp, outs = grid22
    losses = outs[0]["ckpt-losses"]
    c = MEMO.case("llama3.2-1b")
    state = MEMO.state("llama3.2-1b", "adamw")
    step = jax.jit(ref_ts.build_train_step(c["rcfg"], RefCtx(None),
                                           _ref_opt("adamw")))
    want = []
    for batch in _ckpt_batches():
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    cfg = c["cfg"]
    opt = make_optimizer(OptimizerConfig(name="adamw", total_steps=10,
                                         warmup_steps=1))
    ctx = ParallelCtx(Grid.local("cpu"))
    one = ts.make_train_state(cfg, ctx, opt, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    ts.load_state_tree(one, ckpt.restore_checkpoint(
        str(tmp / "ckpt"), 2, ts.state_target(one), device="cpu"))
    fn = ts.build_train_step(cfg, ctx, opt)
    batches = _ckpt_batches()
    got = [float(fn(one, batches[i])[1]["loss"]) for i in (2, 3)]
    np.testing.assert_allclose(got, losses[2:], rtol=1e-5)
    for out in grid21:
        np.testing.assert_allclose(out["ckpt-losses"], losses[2:], rtol=1e-5)


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4)])
def test_gather_params_is_the_inverse_of_shard_params(grid22, grid24, sizes):
    """Every rank's ``gather_params`` of its sharded model gives the whole
    parameters bitwise, unmarked."""
    outs, names = ((grid22[1], REF_ARCH_IDS) if sizes == (2, 2)
                   else (grid24, CASES24))
    for out in outs:
        for name in names:
            assert bool(out[f"unshard-{name}"]), name


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4)])
def test_held_bytes_equal_the_spec_share(grid22, grid24, sizes):
    outs, names = ((grid22[1], REF_ARCH_IDS) if sizes == (2, 2)
                   else (grid24, CASES24))
    grid = Grid(sizes=sizes)
    for name in names:
        cfg = MEMO.case(name)["cfg"]
        model = LM(cfg, device="meta", ep=sizes[1])
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        specs = param_shardings(shapes, grid)
        share = 0
        for n, p in model.named_parameters():
            share += dryrun.rank_bytes(shapes[n], p.element_size(),
                                       specs[n], grid.shape)
        for out in outs:
            assert int(out[f"held-{name}"]) == share, name


def test_meta_count_equals_the_gloo_run(grid22):
    """Rank 0's count of a train step on the 2x2 gloo grid (CPU) equals
    the count of rank (0, 0)'s program on the 2x2 counting grid, to the
    FLOP, the byte, the collective byte and the peak."""
    cfg = MEMO.case("llama3.2-1b")["cfg"]
    ctx = ParallelCtx(Grid(sizes=(2, 2), device=torch.device("meta")))
    opt = make_optimizer(OptimizerConfig(name="adamw"))
    state = ts.abstract_train_state(cfg, ctx, opt)
    batch = {k: torch.empty(v.shape, dtype=torch.int64, device="meta")
             for k, v in MEMO.case("llama3.2-1b")["inputs"].items()}
    _, wc, mem = cost.analyze_step(ts.build_train_step(cfg, ctx, opt), state,
                                   batch, counter=cost.CostCounter("meta"))
    got = grid22[1][0]["count"]
    assert list(got) == [wc.flops, wc.hbm_bytes, wc.coll_bytes,
                         mem.peak_live_bytes]
    assert wc.coll_bytes > 0
