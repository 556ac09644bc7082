"""The LM forward against the JAX package.

The reference's ``init_model`` draws the weights; they reach the port
through ``models.convert.params_from_reference``, and the same seeded
numpy inputs go to both ``forward``s (and ``loss_fn``s), for the SMOKE
configs of llama3.2-1b, gemma-2b, qwen2.5-32b and command-r-35b (GQA,
MQA, qkv biases, an untied head, GeGLU, Dh 8-32), of the recurrent
recurrentgemma-9b (RG-LRU units with a windowed attention block) and
xlstm-1.3b (mLSTM and sLSTM), and of the frontend stubs hubert-xlarge
(frame embeddings only, non-causal) and qwen2-vl-72b (patch embeddings
before the tokens, M-RoPE position streams from the reference's
``mrope_positions``), with and without the attention kernel (the
reference's Pallas kernel in interpret mode; the port's
``ops.flash_attention`` on its CPU route).  Embeddings enter both
packages in the config's dtype.

Tolerances.  At an fp32 copy of each config (a test shape only): rtol
1e-4 and atol 1e-4 * max|logits| against the reference's forward.  At
the configs' bf16: atol 2e-2 * max|logits| against the reference
compiled with ``xla_allow_excess_precision=False``.  By default XLA keeps
some bf16 intermediates of a fusion in fp32 (excess precision), which
moves the reference's own logits by 1.8-2.5 % of max|logits| on these
configs, more than the tolerance; without it every op's result is
rounded to bf16, as the reference's op-by-op (``jax.disable_jit()``)
evaluation and PyTorch do — the compiled and op-by-op references then
agree bitwise — and the port agrees with it within 0.8 %.
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
from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import SKIPS as REF_SKIPS
from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import config as ref_config
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.train.data import mrope_positions
from repro_torch.configs import registry
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import config
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference, reference_leaves
from repro_torch.models.model import (
    LM, apply_block, forward, init_model, loss_fn,
)

DENSE_ARCHS = ["llama3.2-1b", "gemma-2b", "qwen2.5-32b", "command-r-35b"]
MOE_ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
RECURRENT_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b"]
FRONTEND_ARCHS = ["hubert-xlarge", "qwen2-vl-72b"]
LM_ARCHS = DENSE_ARCHS + RECURRENT_ARCHS + FRONTEND_ARCHS
BATCH, SEQ = 2, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cases():
    """(arch, dtype) -> the configs, the reference's params and the port's
    model holding them, and the tokens, built once per module."""
    return {}


def _case(memo, arch, name):
    if (arch, name) not in memo:
        cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                                  dtype=name)
        rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                   dtype=name)
        params = ref_model.init_model(jax.random.PRNGKey(0), rcfg,
                                      RefCtx(None))
        model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                      device="cpu")
        rng = np.random.default_rng(len(arch))
        inputs = {}
        s_text = SEQ
        if cfg.family == "vlm":  # a quarter of the stream is patches
            s_vis = SEQ // 4
            s_text = SEQ - s_vis
            inputs["embeds"] = rng.normal(size=(BATCH, s_vis, cfg.d_model))
            inputs["positions"] = mrope_positions(BATCH, s_vis, s_text)
        elif not cfg.embed_inputs:  # audio: frame embeddings only
            inputs["embeds"] = rng.normal(size=(BATCH, SEQ, cfg.d_model))
        if cfg.embed_inputs:
            inputs["tokens"] = rng.integers(0, cfg.vocab_size,
                                            size=(BATCH, s_text))
        if "embeds" in inputs:  # in the model's dtype, for both packages
            inputs["embeds"] = inputs["embeds"].astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, size=(BATCH, s_text - 8))
        labels[0, :5] = -1  # masked positions
        memo[arch, name] = dict(cfg=cfg, rcfg=rcfg, params=params,
                                model=model, inputs=inputs, labels=labels)
    return memo[arch, name]


def _port_inputs(c, **extra) -> dict:
    dtype = L.torch_dtype(c["cfg"].dtype)
    out = {k: torch.from_numpy(v) for k, v in {**c["inputs"], **extra}.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(dtype)
    return out


def _ref_inputs(c, **extra) -> dict:
    out = {k: jnp.asarray(v) for k, v in {**c["inputs"], **extra}.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].astype(jnp.dtype(c["rcfg"].dtype))
    return out


def _reference(fn, args, name):
    """``fn(*args)`` compiled as the tolerance of ``name`` requires
    (module doc)."""
    options = ({"xla_allow_excess_precision": False}
               if name == "bfloat16" else None)
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


def _hold(got, want, name):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if name == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


#: xlstm-1.3b's bf16 forward is held by
#: ``test_xlstm_bf16_forward_is_held_against_fp32`` instead
FORWARD_CASES = [(arch, name) for arch in LM_ARCHS
                 for name in ("bfloat16", "float32")
                 if (arch, name) != ("xlstm-1.3b", "bfloat16")]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch,name", FORWARD_CASES)
def test_forward_matches_reference(cases, arch, name, use_kernel):
    c = _case(cases, arch, name)
    logits, aux = forward(c["model"], _port_inputs(c), c["cfg"],
                          ParallelCtx(None), use_kernel=use_kernel)
    assert logits.shape == (BATCH, SEQ, c["cfg"].vocab_size)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    want, _ = _reference(lambda params, inputs: ref_model.forward(
        params, inputs, c["rcfg"], RefCtx(None), use_kernel=use_kernel),
        (c["params"], _ref_inputs(c)), name)
    _hold(logits.numpy(), want, name)


def test_xlstm_bf16_forward_is_held_against_fp32(cases):
    """xlstm-1.3b in bf16 at its SMOKE size.  Each of its eight blocks,
    on the reference's own input to it, holds the bf16 tolerance against
    the reference's block.  The whole forward cannot: the mLSTM divides
    by a signed sum of scores (``max(|Σ sw|, e^-m)``), which may cancel,
    so one bf16 rounding that differs in an early block grows over the
    stack — the reference's own bf16 forward is 46-50 % of max|logits|
    from its fp32 forward of the same weights (four token draws), and
    the port's lies 7-16 % from the reference's.  So the port's bf16
    forward is held as ``chip_smoke.py`` holds the LM forwards: no further
    from the reference's fp32 forward than 1.5x the reference's bf16
    forward is, and nearer to the reference's bf16 forward than that is
    to fp32."""
    c = _case(cases, "xlstm-1.3b", "bfloat16")
    ref_ctx = RefCtx(None)
    x = ref_layers.embed(c["params"]["embed"],
                         jnp.asarray(c["inputs"]["tokens"]))
    pos = jnp.broadcast_to(jnp.arange(SEQ)[None], (BATCH, SEQ))
    for j, kind in enumerate(c["cfg"].block_pattern):
        p = jax.tree.map(lambda a: a[0], c["params"]["units"][f"b{j}"])
        want, _ = _reference(lambda p, x: ref_model.apply_block(
            kind, p, x, pos, c["rcfg"], ref_ctx), (p, x), "bfloat16")
        got, _ = apply_block(kind, c["model"].units[0][f"b{j}"],
                             torch.from_numpy(np.array(x, np.float32)).to(
                                 torch.bfloat16),
                             torch.from_numpy(np.array(pos)), c["cfg"],
                             ParallelCtx(None))
        _hold(got.float().numpy(), want, "bfloat16")
        x = want
    logits, _ = forward(c["model"], _port_inputs(c), c["cfg"],
                        ParallelCtx(None))
    want16, _ = _reference(lambda params, inputs: ref_model.forward(
        params, inputs, c["rcfg"], ref_ctx), (c["params"], _ref_inputs(c)),
        "bfloat16")
    rcfg32 = dataclasses.replace(c["rcfg"], dtype="float32")
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), c["params"])
    want32, _ = _reference(lambda params, inputs: ref_model.forward(
        params, inputs, rcfg32, ref_ctx), (params32, _ref_inputs(c)),
        "float32")
    want16, want32 = np.asarray(want16), np.asarray(want32)
    scale = np.abs(want32).max()
    ref_dist = np.abs(want16 - want32).max() / scale
    port_dist = np.abs(logits.numpy() - want32).max() / scale
    assert port_dist <= 1.5 * ref_dist, (port_dist, ref_dist)
    pair = np.abs(logits.numpy() - want16).max() / np.abs(want16).max()
    assert pair <= ref_dist, (pair, ref_dist)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_matches_reference(cases, arch, name):
    """CE + z-loss over a label tail with masked positions, and explicit
    positions (the reference's default ones, or the M-RoPE streams)."""
    c = _case(cases, arch, name)
    extra = {"labels": c["labels"]}
    if "positions" not in c["inputs"]:
        extra["positions"] = np.tile(np.arange(SEQ)[None], (BATCH, 1))
    total, metrics = loss_fn(c["model"], _port_inputs(c, **extra), c["cfg"],
                             ParallelCtx(None))
    ref_batch = _ref_inputs(c, **extra)
    ref_total, ref_metrics = _reference(lambda params, batch: ref_model.loss_fn(
        params, batch, c["rcfg"], RefCtx(None)), (c["params"], ref_batch), name)
    rtol = 2e-2 if name == "bfloat16" else 1e-4
    for key in ("ce", "z_loss", "loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(ref_metrics[key]), rtol=rtol,
                                   err_msg=key)
    assert float(total) == float(metrics["loss"])
    assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_model_mirrors_reference(arch):
    """The port's own init: the reference's parameter paths (scan axis
    unstacked), shapes and dtypes, no gradients, and its distributions."""
    cfg = registry.get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    leaves = reference_leaves(jax.tree.map(np.asarray, ref_model.init_model(
        jax.random.PRNGKey(0), rcfg, RefCtx(None))), rcfg)
    params = dict(model.named_parameters())
    assert set(params) == set(leaves)
    first = {"attn": "attn.wq.w", "rglru": "rec.lambda",
             "mlstm": "rec.w_if.w"}[cfg.block_pattern[0]]
    assert f"units.0.b0.{first}" in params
    assert ("head.w" in params) == (not cfg.tie_embeddings
                                    or not cfg.embed_inputs)
    for key, p in params.items():
        assert tuple(p.shape) == leaves[key].shape, key
        assert str(p.dtype).split(".")[1] == str(leaves[key].dtype), key
        assert not p.requires_grad
    assert torch.all(model.final_norm.scale == 1)
    if cfg.embed_inputs:
        emb = model.embed.embedding.float()
        assert 0.95 < emb.std().item() < 1.05  # N(0, 1)
    else:
        assert model.embed is None
    if cfg.d_ff:
        w = model.units[0]["b0"].ffn.w_down.w.float()
        assert 0.9 < w.std().item() * cfg.d_ff ** 0.5 < 1.1  # N(0, 1/d_in)


def test_params_from_reference_is_exact_and_checks_the_tree():
    cfg = registry.get_config("qwen2.5-32b", smoke=True)
    np_params = jax.tree.map(np.asarray, ref_model.init_model(
        jax.random.PRNGKey(3), ref_get_config("qwen2.5-32b", smoke=True),
        RefCtx(None)))
    leaf = np_params["units"]["b0"]["attn"]["wq"]["w"]
    assert str(leaf.dtype) == "bfloat16"
    with pytest.raises(TypeError):  # why the carry goes through float32
        torch.from_numpy(np.array(leaf))
    model = params_from_reference(np_params, cfg, device="cpu")
    for i in range(cfg.units):
        got = model.units[i]["b0"].attn.wq.w
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      leaf[i].astype(np.float32))
    np.testing.assert_array_equal(model.head.w.float().numpy(),
                                  np_params["head"]["w"].astype(np.float32))
    del np_params["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(np_params, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, ref_model.init_model(
        jax.random.PRNGKey(3), ref_get_config("llama3.2-1b", smoke=True),
        RefCtx(None)))
    with pytest.raises(ValueError, match="differ|shape"):
        params_from_reference(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS + FRONTEND_ARCHS)
def test_params_from_reference_carries_every_leaf(arch):
    """Every leaf of the recurrent and frontend families, ``rec``
    subtrees included (``lambda``, ``conv_w``, ``conv_b``, ``r_gates``,
    ``head_norm``), arrives exactly, in its dtype."""
    cfg = registry.get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    np_params = jax.tree.map(np.asarray, ref_model.init_model(
        jax.random.PRNGKey(5), rcfg, RefCtx(None)))
    leaves = reference_leaves(np_params, rcfg)
    model = params_from_reference(np_params, cfg, device="cpu")
    params = dict(model.named_parameters())
    want = {"recurrentgemma-9b": ["rec.lambda", "rec.conv_w", "rec.conv_b"],
            "xlstm-1.3b": ["rec.conv_w", "rec.head_norm.scale"],
            }.get(arch, [])
    for key in want:
        assert f"units.0.b0.{key}" in params, key
    if arch == "xlstm-1.3b":
        assert "units.0.b7.rec.r_gates" in params
    if arch == "recurrentgemma-9b":
        assert "tail.1.rec.lambda" in params and "tail.1.ffn.w_up.w" in params
    for key, p in params.items():
        assert str(p.dtype).split(".")[1] == str(leaves[key].dtype), key
        np.testing.assert_array_equal(p.float().numpy(),
                                      leaves[key].astype(np.float32),
                                      err_msg=key)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_apply_mrope_matches_reference(name):
    """``apply_mrope`` against the reference's on the same draws and
    position streams (vision patches on a grid, then text), at head
    widths whose bands split unevenly; with three equal streams it is
    ``apply_rope``."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[name]
    rng = np.random.default_rng(0)
    for dh in (8, 16, 128):
        x = rng.normal(size=(2, 40, 3, dh)).astype(np.float32)
        pos = mrope_positions(2, 16, 24)
        got = L.apply_mrope(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(pos), 1e6)
        want = ref_layers.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos),
                                      1e6)
        assert got.dtype == tdt
        _hold(got.float().numpy(), want, name)
        text = np.repeat(np.arange(40)[None, :, None], 2, 0)
        same = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(
            np.repeat(text, 3, -1)), 1e6)
        rope = L.apply_rope(torch.from_numpy(x), torch.from_numpy(text[..., 0]),
                            1e6)
        assert torch.equal(same, rope)


def test_forward_on_the_engine_1x1_matches_xla():
    """``matmul_strategy="summa"``: the FFN projections through the
    port's ``DistributedMatmul`` on the 1x1 grid of the CPU, fp32."""
    cfg = dataclasses.replace(registry.get_config("llama3.2-1b", smoke=True),
                              dtype="float32")
    model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    tokens = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, SEQ)))}
    ctx = ParallelCtx(Grid.local("cpu"), matmul_strategy="summa")
    got, _ = forward(model, tokens, cfg, ctx)
    want, _ = forward(model, tokens, cfg, ParallelCtx(None))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    stats = ctx.matmul().cache_stats()["plan"]
    assert stats["misses"] == 2 and stats["hits"] == 3 * cfg.num_layers - 2


_GRID_PROGRAM = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import shard_params
from repro_torch.models.model import forward, init_model, whole_logits

rank, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                          dtype="float32")
model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
ctx = ParallelCtx(Grid.from_process_group(2, 2, device="cpu"),
                  matmul_strategy="summa")
shard_params(model, ctx.grid)  # the rank's blocks
logits, _ = forward(model, {"tokens": torch.from_numpy(tokens)}, cfg, ctx)
logits = whole_logits(model, logits, cfg, ctx, rows=True)
if rank == 0:
    np.save(out, logits.numpy())
dist.destroy_process_group()
"""


def test_forward_on_a_2x2_gloo_grid_matches_xla(tmp_path):
    """Four gloo processes form the 2x2 grid, each holding its blocks of
    the weights and running its rows of the batch; every FFN projection
    runs task-based SUMMA over it (panel broadcasts along grid rows and
    columns).  The logits, gathered whole, equal the 1x1 ``"xla"``
    forward of the same weights within the oracle tolerance (fp32)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "logits.npy"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _GRID_PROGRAM, str(rank),
             str(tmp_path / "rdv"), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(4)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    cfg = dataclasses.replace(registry.get_config("llama3.2-1b", smoke=True),
                              dtype="float32")
    model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    want, _ = forward(model, {"tokens": torch.from_numpy(tokens)}, cfg,
                      ParallelCtx(None))
    np.testing.assert_allclose(np.load(out), want.numpy(), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)


# ---------------------------------------------------------------------------
# configs, and what is not ported
# ---------------------------------------------------------------------------


def _port_config(rcfg):
    """A reference config rebuilt as the port's dataclass."""
    fields = dataclasses.asdict(rcfg)
    if rcfg.moe is not None:
        fields["moe"] = config.MoEConfig(**fields["moe"])
    return config.ModelConfig(**fields)


def test_registry_and_configs_match_reference():
    assert registry.ARCH_IDS == REF_ARCH_IDS
    assert registry.SKIPS == REF_SKIPS
    assert registry.cell_skip_reason("llama3.2-1b", "long_500k") == (
        "skip(full-attn)")
    for arch in REF_ARCH_IDS:
        for smoke in (False, True):
            rcfg = ref_get_config(arch, smoke=smoke)
            cfg = _port_config(rcfg)
            assert cfg.param_count() == rcfg.param_count(), arch
            assert cfg.active_param_count() == rcfg.active_param_count()
            assert (cfg.units, cfg.tail, cfg.resolved_head_dim) == (
                rcfg.units, rcfg.tail, rcfg.resolved_head_dim)
            port = registry.get_config(arch, smoke=smoke)
            assert dataclasses.asdict(port) == dataclasses.asdict(rcfg), arch
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}
    with pytest.raises(KeyError):
        registry.get_config("gpt-5")


@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x7b", "A9a"), ("kimi-k2-1t-a32b", "A9a"),
    ("recurrentgemma-9b", "A9b"), ("xlstm-1.3b", "A9b"),
    ("hubert-xlarge", "A9d"), ("qwen2-vl-72b", "A9d"),
])
def test_unported_architectures_raise(arch, item):
    """The families the registry and the model refused until they were
    ported — MoE (A9a), the recurrent blocks (A9b), the audio and VLM
    frontends (A9d) — now resolve to the reference's config and build,
    each with the blocks of its family."""
    cfg = _port_config(ref_get_config(arch, smoke=True))
    assert dataclasses.asdict(registry.get_config(arch, smoke=True)) == (
        dataclasses.asdict(cfg))
    model = LM(cfg, device="cpu")
    first = model.units[0]["b0"]
    if item == "A9a":
        assert first.moe is not None
    elif item == "A9b":
        assert first.rec is not None and first.attn is None
        kinds = set(cfg.block_pattern)
        assert kinds == ({"rglru", "attn"} if arch == "recurrentgemma-9b"
                         else {"mlstm", "slstm"})
    else:
        assert first.attn is not None and first.ffn is not None
        assert (model.embed is None) == (not cfg.embed_inputs)
        assert model.head is not None


def test_unported_strategy_raises_in_the_forward(cases):
    """``matmul_strategy="auto"`` (A1), which raised here until the tuner
    was ported, now gives the reference's forward on the 1x1 grid; a
    forward without tokens still raises."""
    from repro.launch.mesh import make_host_mesh

    c = _case(cases, "llama3.2-1b", "float32")
    ctx = ParallelCtx(Grid.local("cpu"), matmul_strategy="auto")
    logits, _ = forward(c["model"], _port_inputs(c), c["cfg"], ctx)
    ref_ctx = RefCtx(make_host_mesh(1, 1), matmul_strategy="auto")
    want, _ = _reference(lambda params, tokens: ref_model.forward(
        params, {"tokens": tokens}, c["rcfg"], ref_ctx),
        (c["params"], _ref_inputs(c)["tokens"]), "float32")
    _hold(logits.numpy(), want, "float32")
    plans = list(ctx.matmul()._plan_cache.values())
    assert plans and all(p.tuned is not None for p in plans)
    with pytest.raises(ValueError, match="tokens"):
        forward(c["model"], {}, c["cfg"], ParallelCtx(None))


def test_model_defaults_to_the_card():
    """Built without a device, a model's parameters are placed on
    ``cuda``: on a machine without a card that raises instead of
    silently running on the CPU."""
    cfg = registry.get_config("llama3.2-1b", smoke=True)
    if torch.cuda.is_available():
        assert LM(cfg).final_norm.scale.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            LM(cfg)
