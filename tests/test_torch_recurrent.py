"""The recurrent blocks (``models/recurrent.py``) against the JAX package.

The reference's ``init_*_block`` draws each block's weights; they reach
the port through ``models.convert.load_leaves``, and the same seeded
numpy inputs go to both packages' blocks at the SMOKE widths of
recurrentgemma-9b (RG-LRU) and xlstm-1.3b (mLSTM, sLSTM): the sequence
forms with and without ``return_state`` (the mLSTM with
``mlstm_chunk`` None, a divisor of S and a non-divisor, which falls
back to the parallel form), ``*_init_state`` and ``*_step``, the
associative scan, the chunkwise mLSTM core, and the port's own init.

Tolerances, as ``tests/test_torch_models.py``: in fp32 rtol 1e-4 and
atol 1e-4 * max|want|; in bf16 atol 2e-2 * max|want| against the
reference compiled with ``xla_allow_excess_precision=False`` (every op
rounded to bf16, as PyTorch rounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import recurrent as R
from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.models import recurrent as P
from repro_torch.models.convert import load_leaves, reference_leaves

BATCH, SEQ, STEPS = 2, 64, 3
ARCH = {"rglru": "recurrentgemma-9b", "mlstm": "xlstm-1.3b",
        "slstm": "xlstm-1.3b"}
PORT_CLASS = {"rglru": P.RGLRUBlock, "mlstm": P.MLSTMBlock,
              "slstm": P.SLSTMBlock}
REF_INIT = {"rglru": R.init_rglru_block, "mlstm": R.init_mlstm_block,
            "slstm": R.init_slstm_block}
PORT_SEQ = {"rglru": P.rglru_block, "mlstm": P.mlstm_block,
            "slstm": P.slstm_block}
REF_SEQ = {"rglru": R.rglru_block, "mlstm": R.mlstm_block,
           "slstm": R.slstm_block}
PORT_STEP = {"rglru": P.rglru_step, "mlstm": P.mlstm_step,
             "slstm": P.slstm_step}
REF_STEP = {"rglru": R.rglru_step, "mlstm": R.mlstm_step,
            "slstm": R.slstm_step}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: (kind, mlstm_chunk): the mLSTM's chunk 16 divides SEQ, 24 does not
SEQUENCE_CASES = [("rglru", None), ("mlstm", None), ("mlstm", 16),
                  ("mlstm", 24), ("slstm", None)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blocks():
    return {}


def _block(memo, kind, name):
    """(cfg, ref cfg, ref params, port block) at ``name``'s dtype."""
    if (kind, name) not in memo:
        cfg = dataclasses.replace(get_config(ARCH[kind], smoke=True),
                                  dtype=name)
        rcfg = dataclasses.replace(ref_get_config(ARCH[kind], smoke=True),
                                   dtype=name)
        params = REF_INIT[kind](jax.random.PRNGKey(7), rcfg, JNP[name])
        block = PORT_CLASS[kind](cfg, dtype=getattr(torch, name),
                                 device="cpu")
        load_leaves(block, reference_leaves(jax.tree.map(np.asarray, params),
                                            rcfg))
        memo[kind, name] = (cfg, rcfg, params, block)
    return memo[kind, name]


def _inputs(shape, name, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, JNP[name]), torch.from_numpy(x).to(getattr(torch,
                                                                      name))


def _reference(fn, args, name):
    """``fn(*args)`` compiled as the tolerance of ``name`` requires."""
    options = ({"xla_allow_excess_precision": False}
               if name == "bfloat16" else None)
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


def _hold(got, want, name, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    got, want = got[finite], want[finite]  # the mLSTM's m may be -inf
    scale = float(np.abs(want).max()) if want.size else 0.0
    if name == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=what)


def _hold_state(got: dict, want: dict, name, what):
    assert set(got) == set(want), what
    for key in want:
        _hold(got[key], want[key], name, f"{what} state[{key!r}]")


# ---------------------------------------------------------------------------
# the sequence forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,chunk", SEQUENCE_CASES)
def test_block_matches_reference(blocks, kind, chunk, name, return_state):
    cfg, rcfg, params, block = _block(blocks, kind, name)
    jx, tx = _inputs((BATCH, SEQ, cfg.d_model), name, seed=len(kind))
    got = PORT_SEQ[kind](block, tx, cfg, ParallelCtx(None, mlstm_chunk=chunk),
                         return_state=return_state)
    want = _reference(lambda p, x: REF_SEQ[kind](
        p, x, rcfg, RefCtx(None, mlstm_chunk=chunk),
        return_state=return_state), (params, jx), name)
    if return_state:
        got, state = got
        want, want_state = want
        _hold_state(state, want_state, name, kind)
    assert got.dtype == getattr(torch, name)
    _hold(got, want, name, kind)


def test_slstm_replicated_changes_nothing(blocks):
    """``slstm_replicated`` only adds a sharding constraint, the identity
    here: the output is bitwise the same."""
    cfg, _, _, block = _block(blocks, "slstm", "float32")
    _, x = _inputs((BATCH, 16, cfg.d_model), "float32", seed=3)
    a = P.slstm_block(block, x, cfg, ParallelCtx(None))
    b = P.slstm_block(block, x, cfg, ParallelCtx(None, slstm_replicated=True))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the serving path's state and step
# ---------------------------------------------------------------------------


def _init_state(kind, block, cfg, batch):
    if kind == "rglru":
        return P.rglru_init_state(block, batch)
    if kind == "mlstm":
        return P.mlstm_init_state(block, cfg, batch)
    return P.slstm_init_state(cfg, batch, device="cpu")


def _ref_init_state(kind, params, rcfg, batch):
    if kind == "rglru":
        return R.rglru_init_state(params, batch)
    if kind == "mlstm":
        return R.mlstm_init_state(params, rcfg, batch)
    return R.slstm_init_state(rcfg, batch)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_init_state_and_step_match_reference(blocks, kind, name):
    """``*_init_state`` equals the reference's; ``STEPS`` tokens of
    ``*_step`` from it, then one more from the state a prefix's
    ``return_state`` left, equal the reference's outputs and states."""
    cfg, rcfg, params, block = _block(blocks, kind, name)
    state = _init_state(kind, block, cfg, BATCH)
    want_state = _ref_init_state(kind, params, rcfg, BATCH)
    _hold_state(state, want_state, "float32", f"{kind} init")
    for key in want_state:
        assert state[key].dtype == torch.float32
    jx, tx = _inputs((BATCH, STEPS + 8, cfg.d_model), name, seed=11)
    for t in range(STEPS):
        got, state = PORT_STEP[kind](block, tx[:, t], state, cfg)
        want, want_state = _reference(
            lambda p, x, s: REF_STEP[kind](p, x, s, rcfg),
            (params, jx[:, t], want_state), name)
        _hold(got, want, name, f"{kind} step {t}")
        _hold_state(state, want_state, name, f"{kind} step {t}")
    _, state = PORT_SEQ[kind](block, tx[:, :8], cfg, ParallelCtx(None),
                              return_state=True)
    _, want_state = _reference(lambda p, x: REF_SEQ[kind](
        p, x, rcfg, RefCtx(None), return_state=True), (params, jx[:, :8]),
        name)
    got, state = PORT_STEP[kind](block, tx[:, 8], state, cfg)
    want, want_state = _reference(
        lambda p, x, s: REF_STEP[kind](p, x, s, rcfg),
        (params, jx[:, 8], want_state), name)
    _hold(got, want, name, f"{kind} step after a prefix")
    _hold_state(state, want_state, name, f"{kind} step after a prefix")


@pytest.mark.parametrize("prefix", [2, 40])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_state_continues_the_sequence(blocks, kind, prefix):
    """``return_state`` over a prefix (shorter than the conv's history,
    and longer), then ``*_step`` over the next tokens, equals the sequence
    form over the whole at those positions (fp32)."""
    cfg, _, _, block = _block(blocks, kind, "float32")
    _, x = _inputs((BATCH, prefix + STEPS, cfg.d_model), "float32", seed=5)
    ctx = ParallelCtx(None)
    whole = PORT_SEQ[kind](block, x, cfg, ctx)
    _, state = PORT_SEQ[kind](block, x[:, :prefix], cfg, ctx,
                              return_state=True)
    for t in range(prefix, prefix + STEPS):
        got, state = PORT_STEP[kind](block, x[:, t], state, cfg)
        _hold(got, whole[:, t], "float32", f"{kind} token {t}")


# ---------------------------------------------------------------------------
# the pieces: scan, chunkwise core, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 2, 7, 64, 129])
def test_associative_scan_matches_lax(length):
    """The port's odd/even scan against ``jax.lax.associative_scan`` of
    the same combine (fp32, equal to the ulp: the same combines in the
    same order), and both against the sequential recurrence."""
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, size=(2, length, 5)).astype(np.float32)
    b = rng.normal(size=(2, length, 5)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want_a, want_y = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    got_a, got_y = P.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=2e-7, atol=0)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=1e-6, atol=1e-6)
    y = np.zeros((2, 5), np.float64)
    seq = []
    for t in range(length):
        y = a[:, t] * y + b[:, t]
        seq.append(y)
    np.testing.assert_allclose(got_y.numpy(), np.stack(seq, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_chunkwise_mlstm_matches_parallel(chunk):
    """As the reference's own test
    (``tests/test_perf_features.py::test_chunkwise_mlstm_matches_parallel``)
    for the port: its chunkwise core against its parallel one, and
    against the reference's chunkwise core, on the same draws."""
    rng = np.random.default_rng(chunk)
    b, h, s, dh = 2, 3, 128, 32
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.normal(size=(b, h, s)).astype(np.float32)
    f_pre = (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    t = [torch.from_numpy(z) for z in (q, k, v, i_pre, f_pre)]
    full = P._mlstm_core(*t)
    ch = P._mlstm_core_chunked(*t, chunk)
    rel = float((full - ch).abs().max() / full.abs().max())
    assert rel < 1e-4, rel
    want = R._mlstm_core_chunked(*(jnp.asarray(z) for z in
                                   (q, k, v, i_pre, f_pre)), chunk)
    _hold(ch, want, "float32", "chunked vs the reference's")


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_init_mirrors_reference(kind):
    """The port's own init: the reference's names, shapes and dtypes, no
    gradients; ``lambda`` the reference's; ``conv_w`` N(0, 1)·0.1,
    ``r_gates`` N(0, 1/D), biases zero, norms one."""
    cfg = dataclasses.replace(get_config(ARCH[kind], smoke=True),
                              d_model=256 if kind != "rglru" else 512)
    rcfg = dataclasses.replace(ref_get_config(ARCH[kind], smoke=True),
                               d_model=cfg.d_model)
    init = {"rglru": P.init_rglru_block, "mlstm": P.init_mlstm_block,
            "slstm": P.init_slstm_block}[kind]
    block = init(cfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    ref = jax.tree.map(np.asarray, REF_INIT[kind](jax.random.PRNGKey(0),
                                                 rcfg))
    leaves = reference_leaves(ref, rcfg)
    params = dict(block.named_parameters())
    assert set(params) == set(leaves)
    for key, p in params.items():
        assert tuple(p.shape) == leaves[key].shape, key
        assert str(p.dtype).split(".")[1] == str(leaves[key].dtype), key
        assert not p.requires_grad
    assert torch.all(block.norm.scale == 1)
    if kind in ("rglru", "mlstm"):
        assert torch.all(block.conv_b == 0)
        assert 0.09 < block.conv_w.float().std().item() < 0.11
    if kind == "slstm":
        std = block.r_gates.float().std().item() * cfg.d_model ** 0.5
        assert 0.9 < std < 1.1
    if kind == "rglru":
        lam = getattr(block, "lambda")
        assert lam.dtype == torch.float32

        def decay(x):  # a = exp(-c softplus(lambda)), in float64
            return np.exp(-8.0 * np.logaddexp(np.asarray(x, np.float64), 0))

        # XLA folds linspace's divisions into constants, so the
        # reference's ramp is itself within 2 ulps of the correctly
        # rounded one; log(expm1(-log(x)/8)) magnifies an ulp of x near
        # 0.999 about 1000-fold, so lambda is held through the decay it
        # encodes: within 4 fp32 ulps (the decays lie in (0.9, 0.999))
        np.testing.assert_allclose(decay(lam.numpy()),
                                   decay(leaves["lambda"]), rtol=0,
                                   atol=4 * 2.0 ** -24)
        np.testing.assert_allclose(decay(lam.numpy())[[0, -1]],
                                   [0.9, 0.999], rtol=1e-6)
