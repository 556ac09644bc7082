"""The mixture-of-experts family against the JAX package.

``models.moe.moe_ffn`` and the mixtral-8x7b / kimi-k2 forwards of the
port against the reference's, for the SMOKE configs of both (top-2 of 4
experts; top-4 of 8 with a shared expert).  The reference draws the
weights (``init_moe``, ``init_model``); they reach the port through
``models.convert``, and the same seeded numpy activations or tokens go
to both.  The expert GEMMs run as ``torch.einsum`` (``use_kernel=False``)
and through ``kernels.ops.grouped_gemm`` (``use_kernel=True``, its plain
version on the CPU); the reference's are einsums either way.

Tolerances, as ``tests/test_torch_models.py`` states them: fp32 rtol
1e-4 and atol 1e-4 x max|want|; bf16 atol 2e-2 x max|want| against the
reference compiled with ``xla_allow_excess_precision=False``.  The aux
loss is an fp32 reduction of the router's probabilities: rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.configs import registry
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.kernels import ops as kops
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import (
    load_leaves,
    params_from_reference,
    reference_leaves,
)
from repro_torch.models.model import LM, forward, init_model, loss_fn

MOE_ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(arch, dtype, capacity_factor=None):
    """The port's and the reference's SMOKE config of ``arch`` in
    ``dtype``, with ``capacity_factor`` when given."""
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype=dtype)
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), dtype=dtype)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=capacity_factor))
    return cfg, rcfg


def _moe_pair(cfg, rcfg, seed=0):
    """The reference's ``init_moe`` params and the port's ``MoE`` holding
    them."""
    dtype = jnp.dtype(rcfg.dtype)
    params = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg, RefCtx(None),
                              dtype=dtype)
    module = load_leaves(
        moe.MoE(cfg, dtype=getattr(torch, cfg.dtype), device="cpu"),
        reference_leaves(jax.tree.map(np.asarray, params), cfg))
    return params, module


def _activations(cfg, seq=SEQ, seed=1):
    x = np.random.default_rng(seed).normal(
        size=(BATCH, seq, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(getattr(torch, cfg.dtype)), x


def _reference(fn, args, dtype):
    options = ({"xla_allow_excess_precision": False}
               if dtype == "bfloat16" else None)
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


def _hold(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _ref_moe_ffn(params, x, rcfg, ctx=None):
    xj = jnp.asarray(x).astype(rcfg.dtype)
    return _reference(lambda p, x: ref_moe.moe_ffn(p, x, rcfg, ctx or RefCtx(
        None)), (params, xj), rcfg.dtype)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("capacity_factor", [32.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, dtype, capacity_factor, use_kernel):
    """Without drops (capacity factor 32) and with them (0.25): the
    output and the aux loss."""
    cfg, rcfg = _configs(arch, dtype, capacity_factor)
    params, module = _moe_pair(cfg, rcfg)
    x, x_np = _activations(cfg)
    got, aux = moe.moe_ffn(module, x, cfg, ParallelCtx(None),
                           use_kernel=use_kernel)
    want, want_aux = _ref_moe_ffn(params, x_np, rcfg)
    assert got.shape == x.shape and got.dtype == x.dtype
    _hold(got, want, dtype)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_drops_only_reduce_magnitude():
    """With a tiny capacity, dropped copies contribute exactly zero: the
    output stays finite and its mass falls (the reference's own test, on
    the port)."""
    cfg, rcfg = _configs("mixtral-8x7b", "float32")
    _, module = _moe_pair(cfg, rcfg)
    x, _ = _activations(cfg)
    big = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=32.0))
    tiny = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.25))
    y_big, _ = moe.moe_ffn(module, x, big, ParallelCtx(None))
    y_tiny, _ = moe.moe_ffn(module, x, tiny, ParallelCtx(None))
    assert torch.isfinite(y_tiny).all()
    assert float(y_tiny.abs().sum()) < float(y_big.abs().sum())


def test_capacity_helpers_match_reference():
    for experts, top_k, cf in ((8, 2, 1.25), (384, 8, 1.25), (4, 2, 0.25),
                               (8, 4, 32.0)):
        port = MoEConfig(num_experts=experts, top_k=top_k, d_ff=64,
                         capacity_factor=cf)
        ref = RefMoEConfig(num_experts=experts, top_k=top_k, d_ff=64,
                           capacity_factor=cf)
        for ep in (1, 3, 4, 16):
            e_pad = moe.padded_experts(port, ep)
            assert e_pad == ref_moe.padded_experts(ref, ep)
            for seq in (1, 16, 4096):
                c = moe.capacity(port, seq, e_pad)
                assert c == ref_moe.capacity(ref, seq, e_pad)
                assert c % 8 == 0 and c >= 8
    # the chip run's shapes: mixtral and kimi-k2 at 4096 tokens
    assert moe.capacity(registry.get_config("mixtral-8x7b").moe, 4096,
                        8) == 1280
    assert moe.capacity(registry.get_config("kimi-k2-1t-a32b").moe, 4096,
                        384) == 112


@pytest.mark.parametrize("use_kernel", [False, True])
def test_registered_weight_mask_matches_reference(use_kernel):
    """Block masks registered for the (d, f) and (f, d) expert shapes
    zero those blocks of every expert, as in the reference."""
    cfg, rcfg = _configs("kimi-k2-1t-a32b", "float32", 32.0)
    params, module = _moe_pair(cfg, rcfg)
    d, f = cfg.d_model, cfg.moe.d_ff
    rng = np.random.default_rng(7)
    masks = {(d, f): rng.random((4, 2)) < 0.6,
             (f, d): rng.random((2, 4)) < 0.6}
    x, x_np = _activations(cfg)
    got, _ = moe.moe_ffn(module, x, cfg,
                         ParallelCtx(None, weight_block_masks=masks),
                         use_kernel=use_kernel)
    want, _ = _ref_moe_ffn(params, x_np, rcfg,
                           RefCtx(None, weight_block_masks=masks))
    _hold(got, want, "float32")
    unmasked, _ = moe.moe_ffn(module, x, cfg, ParallelCtx(None))
    assert not torch.allclose(got, unmasked)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_einsum_route_matches_grouped_gemm_route(monkeypatch, arch, dtype):
    """``use_kernel=True`` multiplies the capacity buffer through
    ``ops.grouped_gemm`` — three calls (gate, up, down) over C-row tiles
    whose experts repeat per batch row — and agrees with the einsum
    route within the tolerance of its dtype."""
    cfg, rcfg = _configs(arch, dtype, 1.25)
    _, module = _moe_pair(cfg, rcfg)
    x, _ = _activations(cfg, seq=64)
    calls = []
    real = kops.grouped_gemm

    def counted(x, w, tile_expert, *, bt, **kw):
        calls.append((tuple(x.shape), tuple(w.shape), bt,
                      np.asarray(tile_expert).tolist()))
        return real(x, w, tile_expert, bt=bt, **kw)

    monkeypatch.setattr(kops, "grouped_gemm", counted)
    got, _ = moe.moe_ffn(module, x, cfg, ParallelCtx(None), use_kernel=True)
    want, _ = moe.moe_ffn(module, x, cfg, ParallelCtx(None))
    e = cfg.moe.num_experts
    cap = moe.capacity(cfg.moe, 64, e)
    assert [c[2] for c in calls] == [cap] * 3
    assert calls[0][3] == list(range(e)) * BATCH
    assert calls[0][0] == (BATCH * e * cap, cfg.d_model)
    _hold(got, want.float().numpy(), dtype)


def test_one_rank_grid_equals_the_local_route():
    """A context with a 1x1 grid runs the expert-parallel program with
    every expert on its one rank: it equals the grid-free route
    bitwise."""
    cfg, rcfg = _configs("kimi-k2-1t-a32b", "float32", 1.25)
    _, module = _moe_pair(cfg, rcfg)
    x, _ = _activations(cfg)
    local, aux = moe.moe_ffn(module, x, cfg, ParallelCtx(None))
    grid, grid_aux = moe.moe_ffn(module, x, cfg,
                                 ParallelCtx(Grid.local("cpu")))
    assert torch.equal(local, grid) and float(aux) == float(grid_aux)
    with pytest.raises(ValueError, match="ep="):
        moe.moe_ffn(moe.MoE(cfg, ep=3, device="cpu"), x, cfg,
                    ParallelCtx(None))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_mirrors_reference(arch):
    """The port's own init: the reference's parameter names, shapes and
    dtypes (experts padded for the expert-parallel degree) and its
    distributions."""
    cfg, rcfg = _configs(arch, "bfloat16")
    for ep in (1, 3):
        module = moe.init_moe(cfg, generator=torch.Generator().manual_seed(0),
                              ep=ep, device="cpu")
        leaves = reference_leaves(jax.tree.map(np.asarray, ref_moe.init_moe(
            jax.random.PRNGKey(0), rcfg,
            RefCtx(None) if ep == 1 else _FakeTpCtx(ep))), cfg)
        params = dict(module.named_parameters())
        assert set(params) == set(leaves)
        for key, p in params.items():
            assert tuple(p.shape) == leaves[key].shape, key
            assert str(p.dtype).split(".")[1] == str(leaves[key].dtype), key
    assert module.router.w.dtype == torch.float32
    for w, fan_in in ((module.w_gate, cfg.d_model), (module.w_down,
                                                     cfg.moe.d_ff)):
        assert 0.9 < w.float().std().item() * fan_in ** 0.5 < 1.1


class _FakeTpCtx:
    """What the reference's ``init_moe`` reads of a context: its tp size."""

    def __init__(self, tp):
        self.tp_size = tp


@pytest.fixture(scope="module")
def lm_cases():
    return {}


def _lm_case(memo, arch, dtype):
    if (arch, dtype) not in memo:
        cfg, rcfg = _configs(arch, dtype)
        params = ref_model.init_model(jax.random.PRNGKey(0), rcfg,
                                      RefCtx(None))
        model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                      device="cpu")
        rng = np.random.default_rng(len(arch))
        tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, 64))
        labels = rng.integers(0, cfg.vocab_size, size=(BATCH, 56))
        labels[0, :5] = -1
        memo[arch, dtype] = dict(cfg=cfg, rcfg=rcfg, params=params,
                                 model=model, tokens=tokens, labels=labels)
    return memo[arch, dtype]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(lm_cases, arch, dtype, use_kernel):
    """The whole smoke forward (two MoE blocks) and its aux loss; the
    port's weights come through ``params_from_reference``."""
    c = _lm_case(lm_cases, arch, dtype)
    logits, aux = forward(c["model"], {"tokens": torch.from_numpy(
        c["tokens"])}, c["cfg"], ParallelCtx(None), use_kernel=use_kernel)
    want, want_aux = _reference(lambda params, tokens: ref_model.forward(
        params, {"tokens": tokens}, c["rcfg"], RefCtx(None),
        use_kernel=use_kernel), (c["params"], jnp.asarray(c["tokens"])),
        dtype)
    assert logits.shape == (BATCH, 64, c["cfg"].vocab_size)
    _hold(logits.numpy(), want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_fn_matches_reference(lm_cases, arch, dtype):
    """CE + z-loss + ``AUX_LOSS_COEF`` x the experts' aux loss."""
    c = _lm_case(lm_cases, arch, dtype)
    batch = {"tokens": torch.from_numpy(c["tokens"]),
             "labels": torch.from_numpy(c["labels"])}
    total, metrics = loss_fn(c["model"], batch, c["cfg"], ParallelCtx(None))
    ref_batch = {"tokens": jnp.asarray(c["tokens"]),
                 "labels": jnp.asarray(c["labels"])}
    _, ref_metrics = _reference(lambda params, batch: ref_model.loss_fn(
        params, batch, c["rcfg"], RefCtx(None)), (c["params"], ref_batch),
        dtype)
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    for key in ("ce", "z_loss", "aux", "loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(ref_metrics[key]), rtol=rtol,
                                   err_msg=key)
    assert float(metrics["aux"]) > 0 and float(total) == float(
        metrics["loss"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_layout_and_init(arch):
    """A MoE block holds ``moe`` and no ``ffn``; ``init_model`` draws the
    reference's parameter paths; a model of experts padded for one
    expert-parallel degree refuses a context of another."""
    cfg = registry.get_config(arch, smoke=True)
    model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    block = model.units[0]["b0"]
    assert block.ffn is None and isinstance(block.moe, moe.MoE)
    assert (block.moe.shared is not None) == bool(
        cfg.moe.num_shared_experts)
    leaves = reference_leaves(jax.tree.map(np.asarray, ref_model.init_model(
        jax.random.PRNGKey(0), ref_get_config(arch, smoke=True),
        RefCtx(None))), cfg)
    assert set(dict(model.named_parameters())) == set(leaves)
    assert "units.0.b0.moe.router.w" in leaves
    assert LM(cfg, device="cpu", ep=3).units[0]["b0"].moe.w_up.shape[0] == (
        moe.padded_experts(cfg.moe, 3))
