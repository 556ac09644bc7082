"""The chunked attention and the plain attention's gradients, against the
JAX package.

``models.chunked_attention.chunked_attention`` (forward and its own
backward) is held against the reference's ``chunked_attention`` through
``jax.vjp`` on the same numpy inputs: the three cases of
``tests/test_perf_features.py:17-20`` (GQA 4/2 heads), MQA (4/1), a
window narrower than a tile (a q-row's first k-tile wholly masked, the
``_NEG`` path) and a length the chunks must be halved to divide, at the
reference's atol 2e-5 (output) and 2e-4 (dQ, dK, dV); a bf16 case at
2e-2 of the largest value.  ``flash_attention_plain``'s gradients (the
``attention_impl="ref"`` route, now out of place while autograd records)
are held against ``jax.grad`` of ``kref.flash_attention_ref``, and the
attention layer's ``"chunked"`` route against its plain one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref
from repro.models.chunked_attention import chunked_attention as ref_chunked
from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.chunked_attention import chunked_attention

# (causal, window, chunk_q, chunk_k, h, hkv, s)
CASES = [
    (True, None, 64, 64, 4, 2, 256),
    (True, 96, 64, 32, 4, 2, 256),
    (False, None, 128, 64, 4, 2, 256),
    (True, None, 64, 64, 4, 1, 256),  # MQA
    (True, 16, 64, 32, 4, 2, 256),  # first k-tile of late rows all masked
    (True, 40, 128, 128, 6, 2, 192),  # chunks halved to 64 to divide S
]
B, DH = 2, 32


def _operands(seed, h, hkv, s, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, s, DH)).astype(dtype)
    k = rng.normal(size=(B, hkv, s, DH)).astype(dtype)
    v = rng.normal(size=(B, hkv, s, DH)).astype(dtype)
    do = rng.normal(size=(B, h, s, DH)).astype(dtype)
    return q, k, v, do


def _port_vjp(fn, q, k, v, do, dtype=torch.float32):
    qt, kt, vt = (torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(torch.tensor(do, dtype=dtype))
    return [t.detach().float().numpy() for t in (out, qt.grad, kt.grad,
                                                 vt.grad)]


def _ref_vjp(fn, q, k, v, do, dtype=jnp.float32):
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))

    res = jax.jit(run)(*(jnp.asarray(x, dtype) for x in (q, k, v, do)))
    return [np.asarray(t, np.float32) for t in res]


@pytest.mark.parametrize("causal,window,cq,ck,h,hkv,s", CASES)
def test_chunked_attention_matches_reference(causal, window, cq, ck, h, hkv,
                                             s):
    q, k, v, do = _operands(s + h + hkv + (window or 0), h, hkv, s)
    kw = dict(causal=causal, window=window, chunk_q=cq, chunk_k=ck)
    got = _port_vjp(lambda *a: chunked_attention(*a, **kw), q, k, v, do)
    want = _ref_vjp(lambda *a: ref_chunked(*a, **kw), q, k, v, do)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
    for name, g, w in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4,
                                   err_msg=f"d{name}")
    # and the reference's other yardstick: the plain attention
    plain = _ref_vjp(lambda *a: flash_attention_ref(
        *a, causal=causal, window=window), q, k, v, do)
    np.testing.assert_allclose(got[0], plain[0], rtol=0, atol=2e-5)
    for g, w in zip(got[1:], plain[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)


def test_chunked_attention_bf16_matches_reference():
    q, k, v, do = _operands(5, 4, 2, 256)
    kw = dict(causal=True, window=96, chunk_q=64, chunk_k=32)
    got = _port_vjp(lambda *a: chunked_attention(*a, **kw), q, k, v, do,
                    torch.bfloat16)
    want = _ref_vjp(lambda *a: ref_chunked(*a, **kw), q, k, v, do,
                    jnp.bfloat16)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("causal,window,h,hkv",
                         [(True, None, 4, 2), (True, 24, 4, 1),
                          (False, None, 4, 4)])
def test_flash_attention_plain_grads_match_reference(causal, window, h, hkv):
    s = 96
    q, k, v, do = _operands(11 + h + hkv, h, hkv, s)
    kw = dict(causal=causal, window=window)
    got = _port_vjp(lambda *a: flash_attention_plain(*a, **kw), q, k, v, do)
    want = _ref_vjp(lambda *a: flash_attention_ref(*a, **kw), q, k, v, do)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
    for name, g, w in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4,
                                   err_msg=f"d{name}")


def test_flash_attention_plain_is_in_place_only_without_autograd():
    """Outside autograd the plain version keeps its in-place route (one
    score buffer), with the same numbers as the recording route."""
    q, k, v, _ = _operands(3, 4, 2, 64)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    with torch.no_grad():
        a = flash_attention_plain(qt, kt, vt, window=16)
    b = flash_attention_plain(qt.clone().requires_grad_(True), kt, vt,
                              window=16)
    assert b.requires_grad
    np.testing.assert_array_equal(a.numpy(), b.detach().numpy())


def test_attention_chunked_route_matches_plain():
    """``ParallelCtx(attention_impl="chunked")`` routes the attention
    layer to the chunked attention: output and parameter gradients equal
    the plain route's within the attention holds."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              dtype="float32")
    layer = init_attention(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    layer.requires_grad_(True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 64, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(64)[None].expand(2, 64)
    outs = {}
    for impl in ("ref", "chunked"):
        layer.zero_grad()
        o = attention(layer, x, pos, cfg, ParallelCtx(None,
                                                      attention_impl=impl))
        o.square().sum().backward()
        outs[impl] = (o.detach().numpy(),
                      {n: p.grad.numpy().copy()
                       for n, p in layer.named_parameters()})
    np.testing.assert_allclose(outs["chunked"][0], outs["ref"][0], rtol=0,
                               atol=2e-5 * np.abs(outs["ref"][0]).max())
    for n, g in outs["ref"][1].items():
        np.testing.assert_allclose(outs["chunked"][1][n], g, rtol=0,
                                   atol=2e-4 * np.abs(g).max(), err_msg=n)
