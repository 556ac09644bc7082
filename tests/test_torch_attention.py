"""The attention slice's modules against the JAX package, on the CPU.

``flash_attention_plain`` (and ``kernels.ops.flash_attention``, whose CPU
route it is) against the reference's Pallas kernel in interpret mode and
its ``flash_attention_ref``, on the shapes of ``tests/test_kernels.py``
with its tolerances (fp32 2e-3, bf16 2e-2); the layers (fp32 1e-5, bf16
2e-2); the attention and FFN sublayers and ``project`` per module.  The
same numpy draws go to both packages.  The CUDA kernel itself runs only
on a card (``tests/test_torch_kernels_gpu.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ORACLE_ATOL, ORACLE_RTOL
from repro.configs.registry import get_config as ref_get_config
from repro.dist.collective_matmul import project as ref_project
from repro.dist.context import ParallelCtx as RefCtx
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch.mesh import make_host_mesh
from repro.models import attention as ref_attention
from repro.models import ffn as ref_ffn
from repro.models import layers as RL
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.collective_matmul import project
from repro_torch.dist.context import ParallelCtx
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
    tma_operand_problems,
)
from repro_torch.models import layers as L
from repro_torch.models.attention import Attention, attention, init_attention
from repro_torch.models.ffn import FFN, ffn, init_ffn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (h, hkv, s, causal, window): tests/test_kernels.py's five shapes
#: the reference's oracle, compiled once per shape
ref_attention_oracle = jax.jit(ref_kernels.flash_attention_ref,
                               static_argnames=("causal", "window"))
FA_SHAPES = [(4, 2, 256, True, None), (4, 1, 256, True, 64),
             (2, 2, 128, False, None), (8, 4, 512, True, 128),
             (2, 2, 256, True, 8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(shape, name, seed, scale=1.0):
    """The same numpy draw as (jax, torch) arrays of one dtype."""
    jdt, tdt = DTYPES[name]
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _fa_tol(name):
    return 2e-2 if name == "bfloat16" else 2e-3


def _ref_params(module, tree):
    """Copy a reference parameter subtree (numpy) into a port module."""
    for path, param in module.named_parameters():
        node = tree
        for key in path.split("."):
            node = node[key]
        param.data.copy_(torch.from_numpy(np.array(node, np.float32)))
    return module


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("h,hkv,s,causal,window", FA_SHAPES)
def test_flash_attention_plain_matches_reference(h, hkv, s, causal, window,
                                                 name):
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(shape, name, seed)
        for seed, shape in enumerate([(2, h, s, 64), (2, hkv, s, 64),
                                      (2, hkv, s, 64)])
    )
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    tol = _fa_tol(name)
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                     bq=128, bk=128)
    oracle = ref_attention_oracle(jq, jk, jv, causal=causal, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # the wrapper's CPU route is the plain version, whatever the tile
    wrapped = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  bq=128, bk=128)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("dh", [8, 80, 112])
def test_flash_attention_plain_head_widths(dh, name):
    """Head widths off the kernel's instances (64, 128, 256): 8 (the
    llama, qwen and command-r smoke configs), 80 (hubert-xlarge, 1280 /
    16) and 112 (kimi-k2), causal with GQA and under a window."""
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(shape, name, seed)
        for seed, shape in enumerate([(2, 4, 128, dh), (2, 2, 128, dh),
                                      (2, 2, 128, dh)], start=dh)
    )
    tol = _fa_tol(name)
    for causal, window in ((True, None), (True, 24)):
        got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  bq=64, bk=64)
        assert got.shape == tq.shape and got.dtype == tq.dtype
        pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, bq=64, bk=64)
        oracle = ref_attention_oracle(jq, jk, jv, causal=causal,
                                      window=window)
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_ragged_length(name):
    """S = 200 is no multiple of any tile: the reference's wrapper falls
    back to its oracle, the port's CPU route is its plain version (its
    CUDA route launches the kernel, which masks the tail)."""
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair((1, 4, 200, 64), name, 10), _pair((1, 2, 200, 64), name, 11),
        _pair((1, 2, 200, 64), name, 12))
    for causal, window in ((True, None), (True, 48), (False, 100)):
        got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
        want = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                       window=window, bq=128, bk=128)
        tol = _fa_tol(name)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_attention_dead_rows_give_zero():
    """Sk = 64 keys, 256 queries, no causal mask, window 64: query q sees
    the keys k > q - 64, so rows 127 and up have no live key.  The port
    gives 0 on each such row.  The Pallas kernel (64-row tiles) gives 0
    on the rows whose whole tile it skips (128 and up); the oracle gives
    NaN there.  On the rows with a live key all three agree.  (Row 127
    sits in a live Pallas tile with no live key of its own; the Pallas
    kernel gives the mean of that tile's values there, from exp(s - m)
    with both at -1e30.)"""
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair((1, 2, 256, 64), "float32", 20),
        _pair((1, 2, 64, 64), "float32", 21),
        _pair((1, 2, 64, 64), "float32", 22))
    got = flash_attention_plain(tq, tk, tv, causal=False, window=64)
    assert torch.all(got[:, :, 127:] == 0)
    assert torch.all(got[:, :, :127].abs().sum(-1) > 0)
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=False, window=64, bq=64, bk=64, interpret=True))
    np.testing.assert_array_equal(_np(got)[:, :, 128:], pallas[:, :, 128:])
    np.testing.assert_allclose(_np(got)[:, :, :127], pallas[:, :, :127],
                               rtol=2e-3, atol=2e-3)
    # the live rows against a softmax over the 64 keys written here (the
    # oracle's mask assumes Sq == Sk)
    q, k, v = _np(tq), _np(tk), _np(tv)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    qi, kj = np.arange(256)[:, None], np.arange(64)[None, :]
    s = np.where(kj > qi - 64, s, -np.inf)[:, :, :127]
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(_np(got)[:, :, :127], want, rtol=2e-3,
                               atol=2e-3)


def test_flash_attention_plain_reads_transposed_views():
    """The attention layer hands over (B, S, H, Dh) -> (B, H, S, Dh)
    transposed views; they give what contiguous copies give."""
    q = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 96, 4, 64)).astype(np.float32)).transpose(1, 2)
    kv = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 96, 2, 64)).astype(np.float32)).transpose(1, 2)
    assert not q.is_contiguous()
    got = flash_attention_plain(q, kv, kv, causal=True, window=None)
    want = flash_attention_plain(q.contiguous(), kv.contiguous(),
                                 kv.contiguous(), causal=True, window=None)
    assert torch.equal(got, want)


def test_flash_attention_cuda_wrapper_refuses_bad_operands():
    """Checks that run before any launch: a CPU tensor, a head width the
    kernel is not built for, mixed dtypes, a broken GQA grouping."""
    q, k = torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="head widths"):
        wide_q, wide_k = torch.zeros((1, 4, 8, 320)), torch.zeros((1, 2, 8, 320))
        flash_attention_cuda(wide_q, wide_k, wide_k)
    with pytest.raises(TypeError, match="dtypes differ"):
        flash_attention_cuda(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_cuda(torch.zeros((1, 3, 8, 64)), k, k)
    assert flash_attention_cuda.launches == before


def test_tma_operand_problems_names_each_condition():
    """What the bf16 kernel's TMA loads cannot take: an address that is not
    16-byte aligned, a sequence, head or batch stride whose bytes are not
    a multiple of 16; a transposed (B, S, H, Dh) view passes, and so does
    any stride of a dimension of extent 1."""
    base = torch.zeros((2, 10, 4, 64), dtype=torch.bfloat16)
    assert tma_operand_problems("q", base.transpose(1, 2)) == []
    flat = torch.zeros(base.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 10, 4, 64).transpose(1, 2)
    (problem,) = tma_operand_problems("q", shifted)
    assert "q.data_ptr() is not 16-byte aligned" in problem
    padded = torch.zeros((2, 4, 10, 68), dtype=torch.bfloat16)[..., :64]
    assert tma_operand_problems("k", padded) == [
        "k's sequence stride of 136 bytes is not a multiple of 16"]
    odd_heads = torch.zeros((3, 10, 3 * 64 + 4), dtype=torch.bfloat16)
    v = odd_heads[..., :192].unflatten(-1, (3, 64)).transpose(1, 2)
    assert v.stride() == (10 * 196, 64, 196, 1)
    assert tma_operand_problems("v", v) == [
        "v's sequence stride of 392 bytes is not a multiple of 16"]
    strided = torch.zeros((3, 2, 8, 64), dtype=torch.bfloat16)[:, :1]
    assert tma_operand_problems("q", strided.as_strided(
        (3, 1, 8, 64), (1028, 7, 64, 1))) == [
        "q's batch stride of 2056 bytes is not a multiple of 16"]
    one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)
    assert tma_operand_problems("q", one.as_strided(
        (1, 1, 1, 64), (3, 5, 7, 1))) == []


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_tol(name):
    return 2e-2 if name == "bfloat16" else 1e-5


@pytest.mark.parametrize("name", list(DTYPES))
def test_norms_match_reference(name):
    jx, tx = _pair((2, 16, 64), name, 30, scale=3.0)
    scale = np.random.default_rng(31).normal(size=(64,)).astype(np.float32)
    bias = np.random.default_rng(32).normal(size=(64,)).astype(np.float32)
    rms = L.RMSNorm(64, device="cpu")
    rms.scale.data.copy_(torch.from_numpy(scale))
    got = L.rmsnorm(rms, tx, 1e-6)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    tol = _layer_tol(name)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    ln = L.LayerNorm(64, device="cpu")
    ln.scale.data.copy_(torch.from_numpy(scale))
    ln.bias.data.copy_(torch.from_numpy(bias))
    got = L.layernorm(ln, tx, 1e-6)
    want = RL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jx, 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_reference(theta, name):
    """Halves rotated (not interleaved pairs), positions up to 4096."""
    jx, tx = _pair((2, 24, 3, 32), name, 40)
    pos = np.random.default_rng(41).integers(0, 4096, size=(2, 24))
    got = L.apply_rope(tx, torch.from_numpy(pos), theta)
    want = RL.apply_rope(jx, jnp.asarray(pos), theta)
    tol = _layer_tol(name)
    atol = tol if name == "bfloat16" else 1e-4  # sin/cos of angles ~4e3
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=atol)
    np.testing.assert_allclose(
        L.rope_frequencies(32, theta).numpy(),
        np.asarray(RL.rope_frequencies(32, theta)), rtol=1e-6)


@pytest.mark.parametrize("name", list(DTYPES))
def test_dense_embed_unembed_match_reference(name):
    jdt, tdt = DTYPES[name]
    jx, tx = _pair((2, 8, 32), name, 50)
    jw, tw = _pair((32, 48), name, 51)
    jb, tb = _pair((48,), name, 52)
    p = L.Dense(32, 48, bias=True, dtype=tdt, device="cpu")
    p.w.data.copy_(tw)
    p.b.data.copy_(tb)
    got = L.dense(p, tx)
    want = RL.dense({"w": jw, "b": jb}, jx)
    tol = _layer_tol(name)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 6)
    je, te = _pair((100, 32), name, 53)
    emb = L.Embedding(100, 32, dtype=tdt, device="cpu")
    emb.embedding.data.copy_(te)
    tokens = np.random.default_rng(54).integers(0, 100, size=(2, 8))
    got = L.embed(emb, torch.from_numpy(tokens))
    np.testing.assert_array_equal(
        _np(got), _np(RL.embed({"embedding": je}, jnp.asarray(tokens))))
    logits = L.unembed(emb, tx)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(RL.unembed({"embedding": je}, jx)),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_activations_round_as_the_reference(act, name):
    """Written op by op in the input's dtype, as jax.nn defines them: in
    bf16 they agree with the reference element for element."""
    jx, tx = _pair((4096,), name, 60, scale=3.0)
    got = L.ACTIVATIONS[act](tx)
    want = RL.ACTIVATIONS[act](jx)
    if name == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# project
# ---------------------------------------------------------------------------


def _weight_mask():
    mask = np.ones((4, 3), bool)
    mask[1, 2] = mask[3, 0] = mask[0, 1] = False
    return mask


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_project_xla_route_matches_reference(masked, name):
    jx, tx = _pair((2, 8, 64), name, 70)
    jw, tw = _pair((64, 96), name, 71)
    mask = _weight_mask() if masked else None
    got = project(tx, tw, ParallelCtx(None), w_mask=mask)
    want = ref_project(jx, jw, RefCtx(None), w_mask=mask)
    assert got.dtype == tx.dtype and got.shape == (2, 8, 96)
    tol = 2e-2 if name == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 8)
    # a mask registered on the context reaches the projection too
    ctx = ParallelCtx(None, weight_block_masks={(64, 96): mask})
    assert torch.equal(project(tx, tw, ctx), got)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("strategy", ["summa", "allgather"])
def test_project_engine_routes_match_reference_1x1(strategy, masked):
    """The engine routes on the 1x1 grid of the CPU against the
    reference's on a 1x1 host mesh, fp32 operands, within the oracle
    tolerance."""
    jx, tx = _pair((3, 32, 64), "float32", 72)
    jw, tw = _pair((64, 96), "float32", 73)
    mask = _weight_mask() if masked else None
    ctx = ParallelCtx(Grid.local("cpu"), matmul_strategy=strategy)
    got = project(tx, tw, ctx, w_mask=mask)
    want = ref_project(jx, jw, RefCtx(make_host_mesh(1, 1),
                                      matmul_strategy=strategy), w_mask=mask)
    assert got.shape == (3, 32, 96) and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), _np(want), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    xla = project(tx, tw, ParallelCtx(None), w_mask=mask)
    np.testing.assert_allclose(_np(got), _np(xla), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    assert ctx.matmul() is ctx.matmul()  # one engine per context


def test_context_matches_reference_fields_and_validation():
    ctx = ParallelCtx(Grid.local("cpu"), dp_axes="data", pure_dp=True)
    ref = RefCtx(make_host_mesh(1, 1), dp_axes="data", pure_dp=True)
    for field in ("dp_axes", "tp_axis", "dp", "dp_size", "tp_size"):
        assert getattr(ctx, field) == getattr(ref, field), field
    assert ParallelCtx(None).dp_size == ParallelCtx(None).tp_size == 1
    assert ctx.wsc(tx := torch.ones(2), "data") is tx
    with pytest.raises(ValueError, match="matmul_strategy"):
        ParallelCtx(None, matmul_strategy="ring")
    with pytest.raises(ValueError, match="needs a grid"):
        ParallelCtx(None, matmul_strategy="summa").matmul()
    with pytest.raises(ValueError, match="not used"):
        ParallelCtx(Grid.local("cpu")).matmul()
    assert ParallelCtx(None).plan_projection(8, 64, 96) is None
    summa = ParallelCtx(Grid.local("cpu"), matmul_strategy="summa")
    plan = summa.plan_projection(8, 64, 96)
    ref_plan = RefCtx(make_host_mesh(1, 1),
                      matmul_strategy="summa").plan_projection(8, 64, 96)
    assert (plan.k_steps, plan.padded_shapes) == (ref_plan.k_steps,
                                                  ref_plan.padded_shapes)
    x = torch.ones((8, 64))
    project(x, torch.ones((64, 96)), summa)
    assert summa.matmul().cache_stats()["plan"]["hits"] >= 1


def test_unported_projection_routes_raise():
    """The ring runs only on a grid with a ``torch.distributed`` world
    behind it (``tests/test_torch_ring.py``, ``tests/test_torch_grid8.py``):
    on a planning-only grid it is refused, under "allgather" and under
    "auto" where its pipeline estimate beats the tuned schedule, as the
    reference's tuner also finds, as every execution is refused there.
    "auto" (A1), which raised here until the tuner was ported, equals the
    reference's projection, masked or not, and
    ``plan_projection(tune=True)`` the reference's tuned plan."""
    from repro.core.plan import plan_matmul as ref_plan_matmul
    from repro.sched import abstract_summa_config, ring_makespan, tune_plan

    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 64), dtype=np.float32)
    w = rng.standard_normal((64, 96), dtype=np.float32)
    w_mask = np.eye(4, 6, dtype=bool) | np.eye(4, 6, 1, dtype=bool)
    auto = ParallelCtx(Grid.local("cpu"), matmul_strategy="auto")
    ref_auto = RefCtx(make_host_mesh(1, 1), matmul_strategy="auto")
    for kw in ({}, dict(w_mask=w_mask)):
        got = project(torch.from_numpy(x), torch.from_numpy(w), auto, **kw)
        want = ref_project(jnp.asarray(x), jnp.asarray(w), ref_auto, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    tuned = [p for p in auto.matmul()._plan_cache.values()]
    assert len(tuned) == 2 and all(p.tuned is not None for p in tuned)
    ring = ParallelCtx(Grid(sizes=(1, 2), device=torch.device("cpu")),
                       matmul_strategy="allgather")
    with pytest.raises(ValueError, match="planning-only grid"):
        project(torch.from_numpy(x), torch.from_numpy(w), ring)
    ring_auto = ParallelCtx(Grid(sizes=(1, 2), device=torch.device("cpu")),
                            matmul_strategy="auto")
    xr, wr = torch.ones((16, 64)), torch.ones((64, 4096))
    with pytest.raises(ValueError, match="planning-only grid"):
        project(xr, wr, ring_auto)
    ref_plan = tune_plan(ref_plan_matmul(
        16, 64, 4096, abstract_summa_config(1, 2, strategy="taskbased")))
    assert ring_makespan(ref_plan) < ref_plan.tuned["makespan_s"]
    plan = ParallelCtx(Grid.local("cpu"), matmul_strategy="summa"
                       ).plan_projection(8, 64, 96, tune=True)
    ref_plan = RefCtx(make_host_mesh(1, 1), matmul_strategy="summa"
                      ).plan_projection(8, 64, 96, tune=True)
    assert plan.tuned == ref_plan.tuned and plan.tuned is not None


# ---------------------------------------------------------------------------
# attention and FFN sublayers
# ---------------------------------------------------------------------------

SUBLAYER_ARCHS = ["llama3.2-1b", "gemma-2b", "qwen2.5-32b"]


def _sublayer_case(arch, name, seed):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=name)
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), dtype=name)
    jdt, tdt = DTYPES[name]
    jx, tx = _pair((2, 40, cfg.d_model), name, seed)
    pos = np.tile(np.arange(40)[None], (2, 1))
    return cfg, rcfg, jdt, tdt, jx, tx, pos


def _module_tol(name):
    return (2e-2, 2e-2) if name == "bfloat16" else (1e-4, 1e-5)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", SUBLAYER_ARCHS)
def test_attention_matches_reference(arch, use_kernel, name):
    """GQA (llama), MQA with Dh 32 (gemma), qkv biases (qwen); the kernel
    flag takes the reference to its Pallas kernel (interpret mode) and
    the port to ``ops.flash_attention``'s CPU route."""
    cfg, rcfg, jdt, tdt, jx, tx, pos = _sublayer_case(arch, name, 80)
    window = 16 if arch == "gemma-2b" else None
    rp = ref_attention.init_attention(jax.random.PRNGKey(1), rcfg, jdt)
    if cfg.qkv_bias:  # non-zero biases, so that they are exercised
        for key in ("wq", "wk", "wv"):
            n = rp[key]["b"].shape[0]
            rp[key]["b"] = jnp.asarray(
                np.random.default_rng(n).normal(size=(n,)), jdt)
    p = _ref_params(Attention(cfg, dtype=tdt, device="cpu"),
                    jax.tree.map(np.asarray, rp))
    got, (gk, gv) = attention(p, tx, torch.from_numpy(pos), cfg,
                              ParallelCtx(None), window=window,
                              use_kernel=use_kernel, return_kv=True)
    want, (wk, wv) = jax.jit(lambda rp, x, pos: ref_attention.attention(
        rp, x, pos, rcfg, RefCtx(None), window=window,
        use_kernel=use_kernel, return_kv=True))(rp, jx, jnp.asarray(pos))
    rtol, atol = _module_tol(name)
    assert got.dtype == tdt and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)
    assert gk.shape == (2, cfg.num_kv_heads, 40, cfg.resolved_head_dim)
    for g, w in ((gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("arch", SUBLAYER_ARCHS)
def test_ffn_matches_reference(arch, name):
    """SwiGLU (llama, qwen) and GeGLU (gemma)."""
    cfg, rcfg, jdt, tdt, jx, tx, _ = _sublayer_case(arch, name, 81)
    rp = ref_ffn.init_ffn(jax.random.PRNGKey(2), rcfg, jdt)
    p = _ref_params(FFN(cfg, dtype=tdt, device="cpu"),
                    jax.tree.map(np.asarray, rp))
    got = ffn(p, tx, cfg, ParallelCtx(None))
    want = jax.jit(lambda rp, x: ref_ffn.ffn(rp, x, rcfg, RefCtx(None)))(
        rp, jx)
    rtol, atol = _module_tol(name)
    assert got.dtype == tdt and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_sublayer_init_mirrors_reference():
    """Shapes, dtypes and distributions of the port's own init."""
    cfg = get_config("qwen2.5-32b", smoke=True)
    rcfg = ref_get_config("qwen2.5-32b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    att = init_attention(cfg, generator=gen, device="cpu")
    ref_att = ref_attention.init_attention(jax.random.PRNGKey(0), rcfg,
                                           jnp.bfloat16)
    f = init_ffn(cfg, generator=gen, device="cpu")
    ref_f = ref_ffn.init_ffn(jax.random.PRNGKey(0), rcfg, jnp.bfloat16)
    for module, tree in ((att, ref_att), (f, ref_f)):
        names = dict(module.named_parameters())
        leaves = {".".join(str(k.key) for k in path): leaf for path, leaf
                  in jax.tree_util.tree_leaves_with_path(tree)}
        assert set(names) == set(leaves)
        for key, param in names.items():
            assert tuple(param.shape) == leaves[key].shape, key
            assert str(param.dtype).split(".")[1] == str(leaves[key].dtype)
            assert not param.requires_grad
    assert torch.all(att.norm.scale == 1) and torch.all(att.wq.b == 0)
    std = att.wq.w.float().std().item() * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1  # N(0, 1/d_in)


def test_chunked_attention_and_mrope_raise():
    cfg = get_config("llama3.2-1b", smoke=True)
    p = init_attention(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.zeros((1, 8), dtype=torch.int64)
    # the chunked attention (A9c), which raised here until it was ported,
    # computes the plain route's attention (held against the reference in
    # tests/test_torch_chunked_attention.py)
    xr = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    posr = torch.arange(8)[None]
    want = attention(p, xr, posr, cfg, ParallelCtx(None)).float()
    got = attention(p, xr, posr, cfg,
                    ParallelCtx(None, attention_impl="chunked")).float()
    assert torch.allclose(got, want, rtol=0,
                          atol=2e-2 * float(want.abs().max()))
    # the kernel flag wins over the implementation switch, as in the
    # reference
    attention(p, x, pos, cfg, ParallelCtx(None, attention_impl="chunked"),
              use_kernel=True)
    # M-RoPE (A9d), which raised here until it was ported, takes three
    # position streams; three equal streams give RoPE's attention
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.arange(8)[None]
    got = attention(p, x, pos[..., None].expand(1, 8, 3),
                    dataclasses.replace(cfg, rope="mrope"), ParallelCtx(None))
    assert torch.equal(got, attention(p, x, pos, cfg, ParallelCtx(None)))
