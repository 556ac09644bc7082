"""The serving engine (``serve/engine.py``) against the JAX package.

The reference's ``init_model`` draws the weights; they reach the port
through ``models.convert.params_from_reference``, its caches through
``cache_from_reference``, and the same seeded numpy tokens go to both
packages' ``prefill`` and ``decode_step`` at the SMOKE configs of every
arch the reference serves (``DECODE_ARCHS``: all but the audio encoder
and the VLM, which has a case of its own with M-RoPE positions).  The
port's prefill attention runs ``ops.flash_attention`` on its CPU route
(the kernel's plain version); the reference's its plain attention.

Tolerances.  fp32: the reference's own serving hold
(``tests/test_serve.py``), atol ``max(2e-3 * max|want|, 1e-3)`` and
rtol 0.01, for logits and for every cache leaf.  bf16:
``tests/test_kernels.py::_tol``'s 2e-2, as atol ``2e-2 * max|want|``,
against the reference compiled with ``xla_allow_excess_precision=False``
(every op rounded to bf16, as PyTorch rounds; see
``tests/test_torch_models.py``).  Each decode step starts from the
reference's cache of the step before, so every step is held on the same
input.  The seq-sharded decode attention runs on a 2x2 grid of four
gloo processes (one spawn) against the reference's single-device
``_decode_attention``.
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
from repro.launch.mesh import make_mesh
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.train.data import mrope_positions
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.models.convert import (
    cache_from_reference,
    cache_to_numpy,
    params_from_reference,
)
from repro_torch.launch import serve
from repro_torch.models.model import forward
from repro_torch.serve import engine, plan_service

S_PRE, N_DEC, B = 24, 4, 2
DECODE_ARCHS = [a for a in REF_ARCH_IDS
                if ref_get_config(a, smoke=True).family not in ("audio", "vlm")]
CTX = ParallelCtx(None)
RCTX = RefCtx(None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_plan_service(monkeypatch):
    """``launch.serve`` reads the plan-service singleton: empty for
    each test, seeded from no file."""
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    plan_service.set_plan_service(None)
    yield
    plan_service.set_plan_service(None)


@pytest.fixture(scope="module")
def cases():
    return {}


def _nodrop(cfg, name):
    cfg = dataclasses.replace(cfg, dtype=name)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


def _case(memo, arch, name):
    """(port cfg, ref cfg, ref params, port model), once per module."""
    if (arch, name) not in memo:
        cfg = _nodrop(get_config(arch, smoke=True), name)
        rcfg = _nodrop(ref_get_config(arch, smoke=True), name)
        params = ref_model.init_model(jax.random.PRNGKey(0), rcfg, RCTX)
        model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                      device="cpu")
        memo[arch, name] = (cfg, rcfg, params, model)
    return memo[arch, name]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=shape)


def _compiled(fn, args, name):
    """``fn`` compiled for ``args`` as the tolerance of ``name`` requires
    (module doc)."""
    options = ({"xla_allow_excess_precision": False}
               if name == "bfloat16" else None)
    return jax.jit(fn).lower(*args).compile(compiler_options=options)


def _hold(got, want, name, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    if name == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0.01,
                                   atol=max(2e-3 * scale, 1e-3),
                                   err_msg=what)


def _flat(tree, prefix=""):
    """Leaves of a cache tree (port tensors, numpy or jax arrays, spec
    tuples) by path."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _hold_cache(got, want, name, what):
    got = _flat(cache_to_numpy(got))
    want = _flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want), what
    for path in want:
        w = np.asarray(want[path])
        assert got[path].shape == w.shape, (what, path)
        if w.dtype == np.int8:  # quantized values: one step of rounding
            assert np.abs(got[path].astype(np.int32)
                          - w.astype(np.int32)).max() <= 1, (what, path)
        elif w.dtype.kind in "iu":
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        else:
            _hold(got[path], w, name, f"{what} {path}")


def _prefill_decode(arch, name, memo, *, ctx=CTX, rctx=RCTX, inputs=None,
                    seed=1):
    """Prefill S_PRE tokens then N_DEC steps in both packages, holding
    logits and the whole cache at each."""
    cfg, rcfg, params, model = _case(memo, arch, name)
    total = S_PRE + N_DEC
    toks = _tokens(cfg, (B, total), seed)
    if inputs is None:
        inputs = {"tokens": toks[:, :S_PRE]}
    ref_pre = _compiled(
        lambda p, x: ref_engine.prefill(p, x, rcfg, rctx, max_len=total),
        (params, jax.tree.map(jnp.asarray, inputs)), name)
    want, rcache = ref_pre(params, jax.tree.map(jnp.asarray, inputs))
    got, cache = engine.prefill(
        model, {k: torch.from_numpy(np.asarray(v)) for k, v in
                inputs.items()}, cfg, ctx, max_len=total)
    _hold(got, want, name, f"{arch} prefill logits")
    _hold_cache(cache, rcache, name, f"{arch} prefill cache")
    ref_dec = _compiled(
        lambda p, c, t: ref_engine.decode_step(p, c, t, rcfg, rctx),
        (params, rcache, jnp.asarray(toks[:, S_PRE])), name)
    for t in range(N_DEC):
        step = toks[:, S_PRE + t]
        cache = cache_from_reference(jax.tree.map(np.asarray, rcache), "cpu")
        want, rcache = ref_dec(params, rcache, jnp.asarray(step))
        got, cache = engine.decode_step(model, cache, torch.from_numpy(step),
                                        cfg, ctx)
        _hold(got, want, name, f"{arch} decode step {t} logits")
        _hold_cache(cache, rcache, name, f"{arch} decode step {t} cache")


#: xlstm-1.3b in bf16 is held block by block
#: (``test_xlstm_bf16_prefill_decode_block_by_block``)
PREFILL_DECODE_CASES = [(arch, name) for arch in DECODE_ARCHS
                        for name in ("float32", "bfloat16")
                        if (arch, name) != ("xlstm-1.3b", "bfloat16")]


@pytest.mark.parametrize("arch,name", PREFILL_DECODE_CASES)
def test_prefill_decode_matches_reference(cases, arch, name):
    assert len(DECODE_ARCHS) == 8
    _prefill_decode(arch, name, cases)


def test_xlstm_bf16_prefill_decode_block_by_block(cases):
    """xlstm-1.3b in bf16.  The mLSTM divides by a signed sum that may
    cancel, so one bf16 rounding that differs in an early block grows over
    the stack (``tests/test_torch_models.py::
    test_xlstm_bf16_forward_is_held_against_fp32``): the whole prefill
    cannot hold 2e-2.  Each of its eight blocks is held instead, on the
    reference's own input to it: the prefill block's output and cache
    (``return_state``), then at each decode step the step block's output
    and new state from the reference's cache."""
    name = "bfloat16"
    cfg, rcfg, params, model = _case(cases, "xlstm-1.3b", name)
    total = S_PRE + N_DEC
    toks = _tokens(cfg, (B, total), 1)
    x = ref_model.embed_inputs(params, {"tokens": jnp.asarray(
        toks[:, :S_PRE])}, rcfg)
    pos = jnp.broadcast_to(jnp.arange(S_PRE)[None], (B, S_PRE))
    rcaches = []
    for j, kind in enumerate(cfg.block_pattern):
        p = jax.tree.map(lambda a: a[0], params["units"][f"b{j}"])
        fn = _compiled(lambda p, x: ref_engine._prefill_block(
            kind, p, x, pos, rcfg, RCTX, B, total), (p, x), name)
        want, rcache = fn(p, x)
        dst = engine._block_cache(kind, cfg, B, total, False, "cpu")
        got = engine._prefill_block(
            kind, model.units[0][f"b{j}"], _bf16(x),
            torch.from_numpy(np.array(pos)), cfg, CTX, total, dst)
        _hold(got, want, name, f"prefill block {j}")
        _hold_cache(dst, rcache, name, f"prefill block {j} cache")
        rcaches.append(rcache)
        x = want
    decode = {}  # block -> its step, compiled once
    for t in range(N_DEC):
        step = jnp.asarray(toks[:, S_PRE + t])
        x_t = ref_model.L.embed(params["embed"], step)
        pos = jnp.full((B,), S_PRE + t, jnp.int32)
        for j, kind in enumerate(cfg.block_pattern):
            p = jax.tree.map(lambda a: a[0], params["units"][f"b{j}"])
            args = (p, x_t, rcaches[j], pos)
            if j not in decode:
                decode[j] = _compiled(
                    lambda p, x, c, pos, kind=kind: ref_engine._decode_block(
                        kind, p, x, pos[:, None], c, pos, rcfg, RCTX),
                    args, name)
            want, rcache = decode[j](*args)
            cache = cache_from_reference(
                jax.tree.map(np.asarray, rcaches[j]), "cpu")
            pos_t = torch.from_numpy(np.array(pos, np.int64))
            got = engine._decode_block(
                kind, model.units[0][f"b{j}"], _bf16(x_t), pos_t[:, None],
                cache, pos_t, cfg, CTX)
            _hold(got, want, name, f"step {t} block {j}")
            _hold_cache(cache, rcache, name, f"step {t} block {j} state")
            rcaches[j] = rcache
            x_t = want


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def test_vlm_prefill_decode_with_mrope_positions(cases):
    """qwen2-vl: patch embeddings before the tokens, M-RoPE (t, h, w)
    position streams at prefill; decode broadcasts the row's position to
    the three streams."""
    cfg, _, _, _ = _case(cases, "qwen2-vl-72b", "float32")
    rng = np.random.default_rng(5)
    s_vis = S_PRE // 4
    inputs = {
        "embeds": rng.normal(size=(B, s_vis, cfg.d_model)).astype(np.float32),
        "tokens": _tokens(cfg, (B, S_PRE - s_vis), 6),
        "positions": np.asarray(mrope_positions(B, s_vis, S_PRE - s_vis)),
    }
    _prefill_decode("qwen2-vl-72b", "float32", cases, inputs=inputs)


def test_kv_quant_prefill_decode_matches_reference(cases):
    """int8 K/V with per-(token, head) fp32 scales: the quantized cache
    (values within one rounding step, scales at the fp32 hold) and the
    logits of prefill and each decode step."""
    for arch in ("llama3.2-1b", "recurrentgemma-9b"):
        _prefill_decode(arch, "float32", cases,
                        ctx=ParallelCtx(None, kv_quant=True),
                        rctx=RefCtx(None, kv_quant=True))


def test_quantize_kv_matches_reference():
    """Round half to even and the clip at ±127, on values at half steps."""
    x = np.random.default_rng(3).normal(size=(2, 3, 7, 16)).astype(np.float32)
    x[0, 0, 0, :] = np.arange(16) - 7.5  # halves: ties to even
    x[1, 2, 3, :] = 0.0  # absmax 0: the 1e-6 floor
    q, s = engine._quantize_kv(torch.from_numpy(x))
    rq, rs = ref_engine._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_sliding_window_ring_cache(cases):
    """Prefill longer than the window: the ring holds the last W tokens
    and decode keeps matching the port's own full forward pass."""
    cfg, _, _, model = _case(cases, "mixtral-8x7b", "float32")
    assert cfg.window is not None and S_PRE > cfg.window
    total = S_PRE + N_DEC
    toks = torch.from_numpy(_tokens(cfg, (B, total), 3))
    full, _ = forward(model, {"tokens": toks}, cfg, CTX)
    _, cache = engine.prefill(model, {"tokens": toks[:, :S_PRE]}, cfg, CTX,
                              max_len=total)
    assert cache["units"]["b0"]["k"].shape[-2] == cfg.window  # O(W) state
    for t in range(N_DEC):
        got, cache = engine.decode_step(model, cache, toks[:, S_PRE + t],
                                        cfg, CTX)
        _hold(got, full[:, S_PRE + t].numpy(), "float32", f"step {t}")


def test_recurrent_state_is_o1_in_seq_len():
    """Cache size does not grow with max_len for the recurrent archs, and
    a windowed one holds at most its window; the port's cache has the
    reference's leaves and shapes."""
    for arch in ("xlstm-1.3b", "recurrentgemma-9b", "mixtral-8x7b"):
        cfg = get_config(arch, smoke=True)
        sizes = {}
        for max_len in (64, 4096):
            c = engine.init_cache(cfg, 1, max_len, device="cpu")
            sizes[max_len] = sum(x.numel() for x in _flat(c).values())
            want = jax.eval_shape(lambda: ref_engine.init_cache(
                ref_get_config(arch, smoke=True), 1, max_len))
            want = {k: v.shape for k, v in _flat(want).items()}
            assert {k: tuple(v.shape) for k, v in _flat(c).items()} == want
        if cfg.window is not None or cfg.family == "ssm":
            assert sizes[4096] <= sizes[64] * (cfg.window or 1) + sizes[64]
        if cfg.family == "ssm":
            assert sizes[64] == sizes[4096], arch  # strictly O(1)


def test_init_cache_matches_reference():
    """Initial states (mLSTM m = -1e30, sLSTM n = 1), int8 leaves, and no
    units: empty stacked leaves."""
    for arch, kv_quant in (("xlstm-1.3b", False), ("llama3.2-1b", True)):
        want = ref_engine.init_cache(ref_get_config(arch, smoke=True), B, 8,
                                     kv_quant=kv_quant)
        got = engine.init_cache(get_config(arch, smoke=True), B, 8,
                                kv_quant=kv_quant, device="cpu")
        _hold_cache(got, want, "float32", arch)
        got, want = _flat(cache_to_numpy(got)), _flat(want)
        for path in want:
            assert got[path].dtype == np.asarray(want[path]).dtype or (
                path == "/pos"), path
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              num_layers=0)
    c = engine.init_cache(cfg, B, 8, device="cpu")
    assert c["units"]["b0"]["k"].shape[0] == 0 and c["tail"] == []


def test_decode_past_capacity_drops_writes(cases):
    """Over-capacity writes are dropped, never clamped onto the final
    slot."""
    cfg, _, _, model = _case(cases, "llama3.2-1b", "float32")
    assert cfg.window is None
    max_len = S_PRE + 2
    toks = torch.from_numpy(_tokens(cfg, (B, max_len + 3), 1))
    _, cache = engine.prefill(model, {"tokens": toks[:, :S_PRE]}, cfg, CTX,
                              max_len=max_len)
    for t in range(2):  # fill to exactly max_len
        _, cache = engine.decode_step(model, cache, toks[:, S_PRE + t], cfg,
                                      CTX)
    full = cache_to_numpy(cache)
    assert int(full["pos"][0]) == max_len
    _, over = engine.decode_step(model, cache, toks[:, max_len], cfg, CTX)
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            over["units"]["b0"][key].numpy(), full["units"]["b0"][key])
    assert int(over["pos"][0]) == max_len + 1


def test_ring_update_rows_at_different_slots():
    """``buf[rows, :, lslot, :]``: the indexed dims go first, (B, Hkv, Dh),
    at B > 1 with each row at its own slot, one past the shard's range
    (dropped) and one in another shard's range (offset)."""
    rng = np.random.default_rng(2)
    buf = rng.normal(size=(4, 2, 6, 3)).astype(np.float32)
    new = rng.normal(size=(4, 2, 1, 3)).astype(np.float32)
    slot = np.array([0, 5, 8, 3])  # row 2 is past the shard
    for offset in (0, 2):
        want = np.asarray(ref_engine._local_ring_update(
            jnp.asarray(buf), jnp.asarray(new), jnp.asarray(slot), offset))
        got = torch.from_numpy(buf.copy())
        engine._local_ring_update(got, torch.from_numpy(new),
                                  torch.from_numpy(slot), offset)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_positions_match_individual_decode(cases):
    """Two batch-1 caches at different prefill depths merged into one
    batch-2 cache: one ragged decode_step equals the two individual
    steps."""
    cfg, _, _, model = _case(cases, "llama3.2-1b", "float32")
    max_len = S_PRE + N_DEC
    toks = torch.from_numpy(_tokens(cfg, (2, max_len), 2))
    lens = (10, S_PRE)
    singles = [engine.prefill(model, {"tokens": toks[i:i + 1, :lens[i]]},
                              cfg, CTX, max_len=max_len)[1]
               for i in range(2)]
    merged = engine.map_cache(
        lambda path, a, b: torch.cat([a, b],
                                     dim=engine.cache_batch_axis(path)),
        singles[0], singles[1])
    assert merged["pos"].tolist() == list(lens)
    step = torch.stack([toks[0, lens[0]], toks[1, lens[1]]])
    logits, merged = engine.decode_step(model, merged, step, cfg, CTX)
    for i in range(2):
        li, _ = engine.decode_step(model, singles[i], step[i:i + 1], cfg, CTX)
        np.testing.assert_allclose(logits[i].numpy(), li[0].numpy(),
                                   atol=2e-4, rtol=1e-3)


def test_active_mask_freezes_inactive_rows(cases):
    cfg, _, _, model = _case(cases, "llama3.2-1b", "float32")
    toks = torch.from_numpy(_tokens(cfg, (B, S_PRE + 2), 4))
    _, cache = engine.prefill(model, {"tokens": toks[:, :S_PRE]}, cfg, CTX,
                              max_len=S_PRE + 2)
    _, cache = engine.decode_step(model, cache, toks[:, S_PRE], cfg, CTX,
                                  active=torch.tensor([1, 0]))
    assert cache["pos"].tolist() == [S_PRE + 1, S_PRE]


# ---------------------------------------------------------------------------
# cache_shardings: one function, classified by leaf name + path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize(
    "arch", ["llama3.2-1b", "xlstm-1.3b", "recurrentgemma-9b"])
def test_cache_shardings_match_reference(arch, kv_quant):
    """Every leaf's spec equals the reference's ``PartitionSpec``; on a
    planning-only 2x2 grid (the reference's abstract mesh of the same
    axes) a batch that divides dp shards over it, one that does not is
    replicated."""
    rcfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    for (rmesh, grid), batch in (
            ((make_mesh((1, 1), ("data", "model")), Grid.local("cpu")), B),
            ((jax.sharding.AbstractMesh((2, 2), ("data", "model")),
              Grid(sizes=(2, 2))), 4),
            ((jax.sharding.AbstractMesh((2, 2), ("data", "model")),
              Grid(sizes=(2, 2))), 3)):
        shapes = jax.eval_shape(
            lambda: ref_engine.init_cache(rcfg, batch, S_PRE,
                                          kv_quant=kv_quant))
        want = ref_engine.cache_shardings(shapes, RefCtx(mesh=rmesh), batch)
        got = engine.cache_shardings(
            engine.init_cache(cfg, batch, S_PRE, kv_quant=kv_quant,
                              device="meta"),
            ParallelCtx(grid), batch)
        want = {k: tuple(v.spec) for k, v in _flat(want).items()}
        assert _flat(got) == want
        assert ("data" in want["/pos"]) == (batch % 2 == 0 or grid.sizes
                                            == (1, 1))


# ---------------------------------------------------------------------------
# 2x2 grid of gloo processes: seq-sharded decode attention
# ---------------------------------------------------------------------------

_RANK_PROGRAM = r"""
import copy
import sys
import warnings
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import shard_params
from repro_torch.models.model import init_model
from repro_torch.serve import engine

rank, rdv, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
grid = Grid.from_process_group(2, 2, device="cpu")
case = np.load(data)
out = {}


def block(x, batch):
    # this rank's block of a (B, Hkv, S, Dh) cache leaf
    spec = engine.cache_shardings({"k": x}, ctx, batch)["k"]
    return engine._block_of(x, spec, grid)


def run(tag, quant, slot, n_valid):
    q, kn, vn = (torch.from_numpy(case[f"{tag}-{n}"]) for n in ("q", "kn", "vn"))
    b = q.shape[0]
    caches = [block(torch.from_numpy(case[f"{tag}-{n}"]), b)
              for n in (("k", "v", "ks", "vs") if quant else ("k", "v"))]
    slot, n_valid = torch.from_numpy(slot), torch.from_numpy(n_valid)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        split = engine.decode_rows(b, ctx)  # as decode_step decides
        if split:  # the rank's rows, which its cache block holds
            q, kn, vn = (ctx.block(t, ctx.dp) for t in (q, kn, vn))
            slot, n_valid = (ctx.block(t, ctx.dp) if t.ndim else t
                             for t in (slot, n_valid))
        res = engine._decode_attention(q, kn, vn, caches[0], caches[1],
                                       slot, n_valid, ctx, *caches[2:])
    out[f"{tag}-warned"] = np.array(
        any("not divisible by dp" in str(w.message) for w in rec))
    o = grid.all_gather(res[0], ctx.dp, 0) if split else res[0]
    for name, t in zip(("o", "k", "v", "ks", "vs"), (o, *res[1:])):
        out[f"{tag}-{name}"] = t.float().numpy()


ctx = ParallelCtx(grid)
for n_valid in (1, 17, 33, 64):
    run(f"plain{n_valid}", False, np.array(n_valid - 1),
        np.array(n_valid))
for b in (4, 3):
    run(f"boundary{b}", False, np.array(7), np.array(8))
ctx = ParallelCtx(grid, kv_quant=True)
n_valid = np.array([1, 9, 17, 32])
run("quant", True, n_valid - 1, n_valid)

# prefill + decode end to end on the grid against one rank
cfg = get_config("llama3.2-1b", smoke=True)
model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
toks = torch.from_numpy(case["tokens"])
for label, c, m in (("grid", ParallelCtx(grid),
                     shard_params(copy.deepcopy(model), grid)),
                    ("one", ParallelCtx(None), model)):
    logits, cache = engine.prefill(m, {"tokens": toks[:, :24]}, cfg, c,
                                   max_len=28)
    steps = [logits]
    for t in range(3):
        logits, cache = engine.decode_step(m, cache, toks[:, 24 + t],
                                           cfg, c)
        steps.append(logits)
    out[f"e2e-{label}"] = torch.stack(steps).numpy()
    out[f"e2e-{label}-k"] = np.array(cache["units"]["b0"]["k"].shape)
# launch.serve on the 2x2 grid (its own groups over the same world)
from repro_torch.launch import serve
out["main"] = serve.main(["--device", "cpu", "--smoke", "--dp", "2",
                          "--tp", "2", "--batch", "2", "--prompt-len", "24",
                          "--gen", "4"])
np.savez(data.replace("case", f"out{rank}"), **out)
dist.destroy_process_group()
"""


def _block(x, rank, batch):
    """Rank ``rank``'s block of a (B, Hkv, S, Dh) leaf on the 2x2 grid
    (``cache_shardings``: batch over data when it divides 2, S over
    model)."""
    d, m = divmod(rank, 2)
    if batch % 2 == 0:
        x = x[d * batch // 2:(d + 1) * batch // 2]
    s = x.shape[2] // 2
    return x[:, :, m * s:(m + 1) * s]


def test_seq_sharded_decode_attention_on_2x2_gloo_grid(tmp_path):
    """Four gloo processes form the 2x2 (data, model) grid: each holds its
    block of the cache (its batch rows and its S-shard) and its rows of
    the step's q and new K/V (``decode_rows``: every row where the batch
    does not divide dp), writes the new token where it owns the slot and
    combines partial softmaxes with all_reduce(max) then all_reduce(sum).
    Against the reference's single-device ``_decode_attention``: the
    output, gathered over dp, within 1e-4, every rank's cache block equal
    to the reference's updated cache there (1e-6), with and without
    ``kv_quant`` (ragged per-row positions); the dp-divisibility warning
    at batch 3 and not at 4.  Then a prefill and three decode steps of
    llama3.2-1b (SMOKE), its weights the rank's blocks, on the grid
    equal the same on one rank, and ``launch.serve.main --dp 2 --tp 2``
    generates the tokens of ``launch.serve`` on one rank."""
    rng = np.random.default_rng(0)
    h, hkv, dh = 8, 2, 16
    arrays, want = {}, {}
    cases = [(f"plain{n}", 4, 64, False, n - 1, n) for n in (1, 17, 33, 64)]
    cases += [(f"boundary{b}", b, 32, False, 7, 8) for b in (4, 3)]
    n_valid = np.array([1, 9, 17, 32])
    cases += [("quant", 4, 32, True, n_valid - 1, n_valid)]
    for tag, b, s, quant, slot, nv in cases:
        a = {"q": rng.normal(size=(b, h, dh)),
             "k": rng.normal(size=(b, hkv, s, dh)),
             "v": rng.normal(size=(b, hkv, s, dh)),
             "kn": rng.normal(size=(b, hkv, 1, dh)),
             "vn": rng.normal(size=(b, hkv, 1, dh))}
        a = {k: jnp.asarray(v, jnp.float32) for k, v in a.items()}
        rctx = RefCtx(None, kv_quant=quant)
        if quant:
            a["k"], a["ks"] = ref_engine._quantize_kv(a["k"])
            a["v"], a["vs"] = ref_engine._quantize_kv(a["v"])
            res = ref_engine._decode_attention(
                a["q"], a["kn"], a["vn"], a["k"], a["v"], jnp.asarray(slot),
                jnp.asarray(nv), rctx, a["ks"], a["vs"])
        else:
            res = ref_engine._decode_attention(
                a["q"], a["kn"], a["vn"], a["k"], a["v"],
                jnp.int32(slot), jnp.int32(nv), rctx)
        arrays.update({f"{tag}-{k}": np.asarray(v) for k, v in a.items()})
        want[tag] = (b, [np.asarray(r, np.float32) for r in res])
    arrays["tokens"] = rng.integers(0, 512, size=(2, 28))
    data = tmp_path / "case.npz"
    np.savez(data, **arrays)
    one_rank = serve.main(["--device", "cpu", "--smoke", "--batch", "2",
                           "--prompt-len", "24", "--gen", "4"])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(rank),
         str(tmp_path / "rdv"), str(data)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    for rank in range(4):
        out = np.load(tmp_path / f"out{rank}.npz")
        for tag, (b, res) in want.items():
            assert bool(out[f"{tag}-warned"]) == (b % 2 == 1), (rank, tag)
            err = np.abs(out[f"{tag}-o"] - res[0]).max()
            assert err < 1e-4, (rank, tag, err)
            for name, r in zip(("k", "v", "ks", "vs"), res[1:]):
                np.testing.assert_allclose(
                    out[f"{tag}-{name}"], _block(r, rank, b), rtol=0,
                    atol=1e-6, err_msg=f"{rank} {tag} {name}")
        np.testing.assert_allclose(out["e2e-grid"], out["e2e-one"],
                                   rtol=1e-5, atol=1e-5)
        # (units, batch rows of this dp rank, Hkv, S-shard, Dh)
        assert out["e2e-grid-k"].tolist() == [2, 1, 2, 14, 8]
        np.testing.assert_array_equal(out["main"], one_rank)
