"""The train step against the JAX package.

The reference's ``make_train_state`` draws a state; it reaches the port
through ``models.convert.train_state_from_reference`` and both packages'
``build_train_step`` take one step on the same ``SyntheticData`` batch.
One step per family's SMOKE config in fp32 — llama3.2-1b (dense, also
with ``microbatches=2``, Adafactor and the chunked attention),
mixtral-8x7b (MoE), hubert-xlarge (frame embeddings) and qwen2-vl-72b
(patch embeddings, M-RoPE): the metrics within rtol 1e-4, then the new
params and every optimizer slot within 1e-4 of each leaf's largest
value.  The recurrent families are in ``tests/test_torch_train_recurrent.py``.

llama3.2-1b in bf16, against the reference compiled without excess
precision (as ``tests/test_torch_models.py`` holds the forward): metrics,
params, master and first moment at 2e-2, the second moment (a square of
the gradient, so twice its relative error) at 4e-2.

Specs: ``state_shardings`` equal to the reference's on a one-device
``(data, model)`` mesh for ``zero1`` False and True and both optimizers,
and ``zero1`` steps bitwise equal.  The abstract state lives on ``meta``.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.launch.mesh import make_mesh
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.data import SyntheticData as RefData
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.models.convert import (
    train_state_from_reference,
    train_state_to_numpy,
)
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves

BATCH, SEQ = 4, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _opt_cfg(name):
    return dict(name=name, total_steps=10, warmup_steps=1)


def _step_both(arch, dtype="float32", name="adamw", microbatches=1,
               impl="ref"):
    """One step in each package from the same state on the same batch;
    returns (port metrics, reference metrics, port state, reference
    state), states as flat numpy dicts."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    ropt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(**_opt_cfg(name)))
    opt = make_optimizer(OptimizerConfig(**_opt_cfg(name)))
    rctx = RefCtx(None, attention_impl=impl)
    rstate = ref_ts.make_train_state(jax.random.PRNGKey(0), rcfg, rctx, ropt)
    state = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       cfg, "cpu")
    batch = RefData(rcfg, BATCH, SEQ, seed=1).batch_at(0)
    fn = ref_ts.build_train_step(rcfg, rctx, ropt, microbatches=microbatches)
    args = (rstate, jax.tree.map(jnp.asarray, batch))
    options = ({"xla_allow_excess_precision": False}
               if dtype == "bfloat16" else None)
    rstate, rmetrics = jax.jit(fn).lower(*args).compile(
        compiler_options=options)(*args)
    step = ts.build_train_step(cfg, ParallelCtx(None, attention_impl=impl),
                               opt, microbatches=microbatches)
    state, metrics = step(state, batch)
    got = dict(leaves(train_state_to_numpy(state)))
    want = {k: np.asarray(v, np.float32) for k, v in leaves(
        jax.tree.map(np.asarray, rstate))}
    return metrics, rmetrics, got, want


def _hold(got, want, tol, *, v_tol=None):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        t = v_tol if v_tol is not None and k.startswith("opt/v/") else tol
        np.testing.assert_allclose(got[k], w, rtol=t,
                                   atol=t * np.abs(w).max(), err_msg=k)


STEP_CASES = [
    ("llama3.2-1b", "adamw", 1, "ref"),
    ("llama3.2-1b", "adamw", 2, "ref"),
    ("llama3.2-1b", "adafactor", 2, "chunked"),
    ("mixtral-8x7b", "adamw", 1, "ref"),
    ("hubert-xlarge", "adamw", 1, "ref"),
    ("qwen2-vl-72b", "adafactor", 1, "ref"),
]


@pytest.mark.parametrize("arch,name,microbatches,impl", STEP_CASES)
def test_train_step_matches_reference_fp32(arch, name, microbatches, impl):
    metrics, rmetrics, got, want = _step_both(
        arch, name=name, microbatches=microbatches, impl=impl)
    for k in rmetrics:
        assert float(metrics[k]) == pytest.approx(float(rmetrics[k]),
                                                  rel=1e-4, abs=1e-6), k
    assert got["step"] == want["step"] == 1
    _hold(got, want, 1e-4)


def test_train_step_matches_reference_bf16():
    metrics, rmetrics, got, want = _step_both("llama3.2-1b", "bfloat16")
    for k in rmetrics:
        assert float(metrics[k]) == pytest.approx(float(rmetrics[k]),
                                                  rel=2e-2, abs=1e-6), k
    _hold(got, want, 2e-2, v_tol=4e-2)


def test_microbatches_accumulate_like_one_batch():
    """The reference's own hold (``tests/test_models.py:120``): two
    microbatches update the params as one batch does, within 5e-2."""
    cfg = get_config("llama3.2-1b", smoke=True)
    opt = make_optimizer(OptimizerConfig(total_steps=10, warmup_steps=1))
    ctx = ParallelCtx(None)
    state = ts.make_train_state(cfg, ctx, opt, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(4, SEQ)),
             "labels": rng.integers(0, cfg.vocab_size, size=(4, SEQ))}
    s1, _ = ts.build_train_step(cfg, ctx, opt)(copy.deepcopy(state), batch)
    s2, _ = ts.build_train_step(cfg, ctx, opt, microbatches=2)(state, batch)
    p1 = dict(s1["params"].named_parameters())
    d = max(float((p.detach().float() - p1[n].detach().float()).abs().max())
            for n, p in s2["params"].named_parameters())
    assert d < 5e-2


def _ref_specs(shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    out = {}
    for keypath, sh in flat:
        parts = [str(k.key) if hasattr(k, "key") else str(k.idx)
                 for k in keypath]
        out["/".join(parts)] = tuple(sh.spec)
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_state_shardings_match_reference(arch, zero1, name):
    mesh = make_mesh((1, 1), ("data", "model"))
    rctx = RefCtx(mesh, zero1=zero1)
    ropt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(**_opt_cfg(name)))
    rcfg = ref_get_config(arch, smoke=True)
    with mesh:
        abstract = ref_ts.abstract_train_state(jax.random.PRNGKey(0), rcfg,
                                               rctx, ropt)
        want = _ref_specs(ref_ts.state_shardings(abstract, rctx))
    ctx = ParallelCtx(Grid.local("cpu"), zero1=zero1)
    state = ts.abstract_train_state(get_config(arch, smoke=True), ctx,
                                    make_optimizer(OptimizerConfig(
                                        **_opt_cfg(name))))
    assert all(t.device.type == "meta" for _, t in leaves(state["opt"]))
    got = dict(leaves(ts.state_shardings(state, ctx)))
    assert got == want
    batch = RefData(rcfg, 2, 8).batch_at(0)
    assert ts.batch_shardings(batch, ctx) == {
        k: tuple(v.spec) for k, v in ref_ts.batch_shardings(
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         batch), rctx).items()}


def test_zero1_changes_no_number():
    cfg = get_config("llama3.2-1b", smoke=True)
    opt = make_optimizer(OptimizerConfig(total_steps=10, warmup_steps=1))
    state = ts.make_train_state(cfg, ParallelCtx(None), opt,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    batch = RefData(ref_get_config("llama3.2-1b", smoke=True), 4,
                    SEQ).batch_at(0)
    out = []
    for zero1 in (False, True):
        ctx = ParallelCtx(Grid.local("cpu"), zero1=zero1)
        s = copy.deepcopy(state)
        step = ts.build_train_step(cfg, ctx, opt, microbatches=2)
        for _ in range(2):
            s, m = step(s, batch)
        out.append((float(m["loss"]), train_state_to_numpy(s)))
    assert out[0][0] == out[1][0]
    a, b = dict(leaves(out[0][1])), dict(leaves(out[1][1]))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "qwen2.5-32b"])
def test_param_shardings_filters_match_reference(arch):
    """``param_shardings(fsdp=, tp=)`` drops the FSDP / TP axis as the
    reference's ``_filter_spec`` does, then degrades indivisible dims, on
    planning grids of several shapes."""
    from repro.dist import partitioning as ref_part
    from repro_torch.dist import partitioning as part
    from repro_torch.models.model import LM
    from test_torch_launch import _Shape, _reference_specs

    model = LM(get_config(arch, smoke=True), device="meta")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    want = _reference_specs(arch)
    for sizes in ((2, 4), (3, 1), (1, 1)):
        grid = Grid(sizes=sizes)
        for fsdp in (True, False):
            for tp in (True, False):
                got = part.param_shardings(shapes, grid, fsdp=fsdp, tp=tp)
                for name, (spec, shape) in want.items():
                    ref = ref_part._validate_spec(
                        ref_part._filter_spec(
                            jax.sharding.PartitionSpec(*spec), fsdp=fsdp,
                            tp=tp), shape, _Shape(grid.shape))
                    assert got[name] == tuple(ref), (name, sizes, fsdp, tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_f32_gradients_match_reference(dtype):
    """``layers.matmul_f32`` (an autograd Function since ``torch.mm(...,
    out_dtype=...)`` has no derivative) against ``jax.vjp`` of the
    reference's ``einsum(..., preferred_element_type=float32)``: each
    operand's gradient in its dtype, within the dtype's tolerance."""
    from repro_torch.models.layers import matmul_f32

    rng = np.random.default_rng(0)
    x, w, g = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 5, 48), (48, 24), (2, 5, 24)))
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "...d,df->...f", a, b, preferred_element_type=jnp.float32),
        jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want = [np.asarray(t, np.float32) for t in (out, *vjp(jnp.asarray(g)))]
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    wt = torch.tensor(w).to(tdt).requires_grad_(True)
    y = matmul_f32(xt, wt)
    y.backward(torch.tensor(g))
    assert y.dtype == torch.float32
    assert xt.grad.dtype == wt.grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, w_ in zip((y, xt.grad, wt.grad), want):
        np.testing.assert_allclose(got.detach().float().numpy(), w_,
                                   rtol=tol, atol=tol * np.abs(w_).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_f32_out_dtype_gradients_match_reference(dtype):
    """``matmul_f32(..., out_dtype=x.dtype)`` (the projections' route:
    the cotangent arrives in the output's dtype) against ``jax.vjp`` of
    the reference's ``einsum(..., preferred_element_type=float32)
    .astype(dtype)``."""
    from repro_torch.models.layers import matmul_f32

    rng = np.random.default_rng(1)
    x, w, g = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 4, 40), (40, 56), (3, 4, 56)))
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "...d,df->...f", a, b, preferred_element_type=jnp.float32
    ).astype(jdt), jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want = [np.asarray(t, np.float32)
            for t in (out, *vjp(jnp.asarray(g, jdt)))]
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    wt = torch.tensor(w).to(tdt).requires_grad_(True)
    y = matmul_f32(xt, wt, out_dtype=tdt)
    y.backward(torch.tensor(g).to(tdt))
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, w_ in zip((y, xt.grad, wt.grad), want):
        np.testing.assert_allclose(got.detach().float().numpy(), w_,
                                   rtol=tol, atol=tol * np.abs(w_).max())


@pytest.mark.parametrize("strategy", ["summa", "allgather", "auto"])
@pytest.mark.parametrize("masked", [False, True])
def test_engine_projection_gradients_match_xla(strategy, masked):
    """``project`` on the engine (``_EngineMatmul``: two more engine
    products in the backward, the weight's block mask on dW and its
    transpose on dX) gives the xla route's gradients."""
    from repro_torch.dist.collective_matmul import project

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    g = rng.normal(size=(2, 16, 96)).astype(np.float32)
    mask = rng.random((4, 3)) < 0.6 if masked else None
    grads = {}
    for route in ("xla", strategy):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        ctx = ParallelCtx(Grid.local("cpu"), matmul_strategy=route)
        y = project(xt, wt, ctx, w_mask=mask)
        y.backward(torch.tensor(g))
        grads[route] = [t.detach().numpy() for t in (y, xt.grad, wt.grad)]
    for got, want in zip(grads[strategy], grads["xla"]):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    if masked:
        keep = np.kron(mask, np.ones((16, 32), bool))
        assert not grads[strategy][2][~keep].any()
