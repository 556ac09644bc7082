"""The kernel modules: plain versions and wrappers against the reference.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run each kernel's
plain PyTorch version; they are held against the reference's
``repro.kernels.ops`` run in interpret mode, on a trimmed sweep of
``tests/test_kernels.py`` with its tolerances.  The CUDA kernels
themselves run only on a card: the tests marked ``gpu`` compare them with
their plain versions there (``tests/test_torch_kernels_gpu.py``).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import random_block_mask
from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops
from repro_torch.kernels.bsmm import bsmm_cuda, bsmm_plain, tile_lists
from repro_torch.kernels.tiled_matmul import tiled_matmul_cuda, tiled_matmul_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 1e-4


def _operands(shapes, name, seed):
    """The same numpy draws as (jax, torch) arrays of one dtype."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.normal(size=shape).astype(np.float32)
        out.append((jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(got, want, name, k):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=_tol(name), atol=_tol(name) * k ** 0.5,
    )


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (96, 160, 224), (100, 60, 36)])
def test_tiled_matmul_matches_reference(m, k, n, name):
    (ja, ta), (jb, tb) = _operands([(m, k), (k, n)], name, seed=m + k + n)
    got = ops.tiled_matmul(ta, tb, bm=64, bk=64, bn=64)
    assert got.shape == (m, n) and got.dtype == ta.dtype
    _close(got, ref_ops.tiled_matmul(ja, jb, bm=64, bk=64, bn=64), name, k)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("fill", [0.1, 1.0])
@pytest.mark.parametrize("mb,kb", [(4, 8), (8, 4)])
def test_bsmm_matches_reference(fill, mb, kb, name):
    m, k, n = mb * 32, kb * 32, 96
    (ja, ta), (jb, tb) = _operands([(m, k), (k, n)], name, seed=mb * kb)
    mask = random_block_mask(mb, kb, fill, seed=int(fill * 10) + mb)
    got = ops.bsmm(ta, tb, mask, bn=32)
    assert got.shape == (m, n) and got.dtype == ta.dtype
    _close(got, ref_ops.bsmm(ja, jb, mask, bn=32), name, k)


def test_bsmm_empty_rows_give_zero():
    mask = np.zeros((4, 4), dtype=bool)
    mask[0, 0] = True  # only one live block
    (ja, ta), (jb, tb) = _operands([(128, 128), (128, 64)], "float32", seed=3)
    out = ops.bsmm(ta, tb, mask, bn=32)
    assert torch.all(out[32:] == 0.0)
    assert torch.any(out[:32] != 0.0)
    _close(out, ref_ops.bsmm(ja, jb, mask, bn=32), "float32", 128)


def _split_bf16(x: torch.Tensor):
    """hi = bf16(x), lo = bf16(x - hi), as fp32 (csrc/split_gemm.cuh)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("case", ["dense_panel", "bsmm_row_of_52"])
def test_split_bf16_product_holds_the_fp32_tolerance(case):
    """The split of the CUDA tiled_matmul and bsmm kernels for fp32
    operands, emulated: each operand split into bf16 hi and lo, three
    products hi·hi + hi·lo + lo·hi (a bf16 product is exact in fp32),
    against the reference's kernels in interpret mode at the fp32
    tolerance (rtol 1e-4, atol 1e-4·√K): the main path's K = 256 panel,
    and a block row of 52 live 256-wide blocks (K = 13312) at a narrow M
    and N.  One bf16 product fails the hold.  The sums here are torch's
    on the CPU, true fp32: this pins the split's rounding only.  The
    tensor cores' accumulation, and the fp32 C's sum in parts of
    K = 2048, are the GPU tests' (``test_tiled_matmul_split_kernel_long_k``,
    ``test_bsmm_split_kernel_long_row``)."""
    if case == "dense_panel":
        m, k, n = 64, 256, 128
    else:
        m, k, n = 8, 52 * 256, 16
    (ja, ta), (jb, tb) = _operands([(m, k), (k, n)], "float32", seed=k)
    if case == "dense_panel":
        want = ref_ops.tiled_matmul(ja, jb, bm=64, bk=64, bn=64)
    else:
        want = ref_ops.bsmm(ja, jb, np.ones((1, 52), bool), bn=16)
    want = np.asarray(want, np.float32)
    a_hi, a_lo = _split_bf16(ta)
    b_hi, b_lo = _split_bf16(tb)
    got = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * k ** 0.5)
    one = (a_hi @ b_hi).numpy()
    assert not np.allclose(one, want, rtol=1e-4, atol=1e-4 * k ** 0.5)


@pytest.mark.parametrize("dim", [1, 7, 8, 36, 60, 64, 100, 255, 256, 300, 1000])
@pytest.mark.parametrize("pref", [64, 256])
def test_pick_tile_matches_reference(dim, pref):
    assert ops._pick_tile(dim, pref) == ref_ops._pick_tile(dim, pref)


def test_plain_versions_on_views_and_sentinels():
    """The plain versions take strided panel views, and the bsmm plain
    version reads a column map the way the kernel does: up to the first
    entry of each row that is -1 or at or past K/bk."""
    rng = np.random.default_rng(1)
    wide = torch.from_numpy(rng.normal(size=(40, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32, 24)).astype(np.float32))
    panel = wide[:, 32:64]  # row stride 96, like a SUMMA A panel
    np.testing.assert_allclose(
        tiled_matmul_plain(panel, b).numpy(),
        panel.numpy() @ b.numpy(), rtol=1e-5, atol=1e-5,
    )
    a = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    cols = torch.tensor([[1, -1, 0], [-1, -1, -1]], dtype=torch.int32)
    got = bsmm_plain(a, b, cols, bm=8, bk=16, bn=8)
    want = a[:8, 16:].numpy() @ b[16:].numpy()
    np.testing.assert_allclose(got[:8].numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[8:] == 0)
    past = torch.tensor([[1, 2, 0], [2, 0, -1]], dtype=torch.int32)
    got = bsmm_plain(a, b, past, bm=8, bk=16, bn=8)  # walk ends at K/bk = 2
    np.testing.assert_allclose(got[:8].numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[8:] == 0)


@pytest.mark.parametrize("fill", [0.1, 0.3, 0.7])
def test_bsmm_plain_tile_map_reads_only_the_listed_blocks(fill):
    """A tile map (one list a block row and 256-column tile, N = 556 off
    the tile) against float64: every dead block of A, and every block of
    B that no list of its tile names, holds NaN, and C is finite and
    equals the product of the listed blocks.  ``tile_lists`` keeps a
    block row's entries, in order, where B's block under the tile is
    live; a tile whose lists are all empty gives zero columns."""
    rng = np.random.default_rng(int(fill * 10))
    bm, bk, mb, kb, n = 8, 16, 4, 6, 556
    a_mask = rng.random((mb, kb)) < fill
    a_mask[0] = True
    live = rng.random((kb, 3)) < fill
    live[:, 1] = False
    cols = np.full((mb, kb), -1, np.int32)
    for i in range(mb):
        row = np.flatnonzero(a_mask[i])
        cols[i, :len(row)] = row
    tiles = tile_lists(cols, live)
    assert tiles.shape[:2] == (mb, 3) and tiles.dtype == np.int32
    for i in range(mb):
        for t in range(3):
            want = [kk for kk in np.flatnonzero(a_mask[i]) if live[kk, t]]
            got = tiles[i, t]
            assert list(got[:len(want)]) == want
            assert (got[len(want):] == -1).all()
    a = rng.normal(size=(mb * bm, kb * bk))
    b = rng.normal(size=(kb * bk, n))
    a[~np.kron(a_mask, np.ones((bm, bk), bool))] = np.nan
    read = np.zeros((kb, n), bool)
    for t in range(3):
        read[:, 256 * t:256 * (t + 1)] = (live[:, t] & a_mask.any(0))[:, None]
    b[~np.repeat(read, bk, axis=0)] = np.nan
    got = bsmm_plain(torch.from_numpy(a).float(), torch.from_numpy(b).float(),
                     torch.from_numpy(tiles), bm=bm, bk=bk, bn=4)
    assert torch.isfinite(got).all()
    want = np.zeros((mb * bm, n))
    for t in range(3):
        cs = slice(256 * t, 256 * (t + 1))
        for i in range(mb):
            for kk in tiles[i, t][tiles[i, t] >= 0]:
                want[i * bm:(i + 1) * bm, cs] += (
                    a[i * bm:(i + 1) * bm, kk * bk:(kk + 1) * bk]
                    @ b[kk * bk:(kk + 1) * bk, cs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * (kb * bk) ** 0.5)
    assert torch.all(got[:, 256:512] == 0)


def test_wrappers_route_by_device():
    # a meta tensor takes the shape-only route; no other device has one
    x = torch.zeros((8, 8), device="meta")
    assert ops.tiled_matmul(x, x).device.type == "meta"
    c = ops.bsmm_cols(x, x, torch.zeros((1, 1), dtype=torch.int32),
                      bm=8, bk=8, bn=8)
    assert c.device.type == "meta" and c.shape == (8, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")),
                   tiled_matmul_cuda, None, None)
    before = (tiled_matmul_cuda.launches, bsmm_cuda.launches)
    ops.tiled_matmul(torch.ones(8, 8), torch.ones(8, 8))
    ops.bsmm(torch.ones(8, 8), torch.ones(8, 8), np.ones((1, 1), bool))
    # the CPU path never counts a kernel launch
    assert (tiled_matmul_cuda.launches, bsmm_cuda.launches) == before


def test_kernel_wrappers_reject_cpu_tensors():
    a = torch.ones(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tiled_matmul_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        bsmm_cuda(a, a, torch.zeros((1, 1), dtype=torch.int32),
                  bm=8, bk=8, bn=8)
