"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  The file imports neither ``jax`` nor
``repro``, so it runs on a GPU machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Shapes and tolerances are those of ``tests/test_kernels.py`` (fp32 1e-4,
bf16 2e-2, atol scaled by sqrt(K); attention fp32 2e-3, bf16 2e-2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import (
    block_csr_from_mask,
    decay_rank_map,
    random_block_mask,
    synthesize_rank_csr,
)
from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.bsmm import bsmm_cuda, bsmm_plain, tile_lists
from repro_torch.kernels.grouped_gemm import grouped_gemm_cuda, grouped_gemm_plain
from repro_torch.kernels.tiled_matmul import tiled_matmul_cuda, tiled_matmul_plain
from repro_torch.models.model import forward, init_model

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rand(shape, name, seed, device):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device, DTYPES[name])


def _close(got, want, name, k):
    tol = 2e-2 if name == "bfloat16" else 1e-4
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(),
        rtol=tol, atol=tol * k ** 0.5,
    )


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "m,k,n", [(64, 64, 64), (128, 256, 64), (96, 160, 224), (100, 60, 36)]
)
def test_tiled_matmul_kernel_matches_plain(cuda, m, k, n, name):
    a = _rand((m, 2 * k), name, m * n, cuda)[:, k:]  # a strided panel view
    b = _rand((k, n), name, k, cuda)
    before = tiled_matmul_cuda.launches
    got = tiled_matmul_cuda(a, b)
    assert tiled_matmul_cuda.launches == before + 1
    assert got.shape == (m, n) and got.dtype == a.dtype
    _close(got, tiled_matmul_plain(a, b), name, k)
    _close(ops.tiled_matmul(a, b, bm=64, bk=64, bn=64),
           tiled_matmul_plain(a, b), name, k)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("fill", [0.1, 0.4, 1.0])
@pytest.mark.parametrize("mb,kb", [(4, 8), (2, 2), (8, 4)])
def test_bsmm_kernel_matches_plain(cuda, fill, mb, kb, name):
    m, k, n = mb * 32, kb * 32, 96
    a, b = _rand((m, k), name, mb, cuda), _rand((k, n), name, kb, cuda)
    mask = random_block_mask(mb, kb, fill, seed=int(fill * 10) + mb)
    csr = block_csr_from_mask(mask)
    cols = torch.as_tensor(csr.padded_cols(max(csr.max_row_nnz, 1)),
                           dtype=torch.int32, device=cuda)
    before = bsmm_cuda.launches
    got = bsmm_cuda(a, b, cols, bm=32, bk=32, bn=32)
    assert bsmm_cuda.launches == before + 1
    _close(got, bsmm_plain(a, b, cols, bm=32, bk=32, bn=32), name, k)
    _close(ops.bsmm(a, b, mask, bn=32),
           bsmm_plain(a, b, cols, bm=32, bk=32, bn=32), name, k)


def test_bsmm_kernel_empty_rows_and_bad_maps(cuda):
    mask = np.zeros((4, 4), dtype=bool)
    mask[0, 0] = True
    a, b = _rand((128, 128), "float32", 1, cuda), _rand((128, 64), "float32", 2, cuda)
    out = ops.bsmm(a, b, mask, bn=32)
    torch.cuda.synchronize()
    assert torch.all(out[32:] == 0) and torch.any(out[:32] != 0)
    bad = torch.tensor([[4], [-1], [-1], [-1]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="block column"):
        ops.bsmm_cols(a, b, bad.cpu().numpy(), bm=32, bk=32, bn=32)
    # the kernel itself ends a row's walk at a column past K/bk: row 0 sums
    # block 0 only, row 1 nothing, and nothing past A is read
    past = torch.tensor([[0, 4, 1], [7, 0, -1], [2, -1, -1], [-1, -1, -1]],
                        dtype=torch.int32, device=cuda)
    kept = torch.tensor([[0, -1, -1], [-1, -1, -1], [2, -1, -1],
                         [-1, -1, -1]], dtype=torch.int32, device=cuda)
    got = bsmm_cuda(a, b, past, bm=32, bk=32, bn=32)
    _close(got, bsmm_plain(a, b, kept, bm=32, bk=32, bn=32), "float32", 128)
    _close(bsmm_plain(a, b, past, bm=32, bk=32, bn=32),
           bsmm_plain(a, b, kept, bm=32, bk=32, bn=32), "float32", 128)
    assert torch.all(got[32:64] == 0) and torch.all(got[96:] == 0)
    with pytest.raises(ValueError, match="contiguous"):
        bsmm_cuda(a.t(), b, bad.clamp(max=0), bm=32, bk=32, bn=32)
    with pytest.raises(ValueError, match="unit column stride"):
        tiled_matmul_cuda(a.t(), b)


#: (input, output) dtype pairs the matmul kernels take
DTYPE_PAIRS = [(i, o) for i in DTYPES for o in DTYPES]


def _pair_name(pair):
    """The reference's tolerance for a pair: bf16 if either side is."""
    return "bfloat16" if "bfloat16" in pair else "float32"


@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids="-".join)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize(
    "m,k,n", [(200, 256, 300), (130, 100, 520), (70, 33, 260),
              (1, 256, 700), (300, 256, 1), (257, 77, 513)])
def test_tiled_matmul_split_kernel_edges(cuda, m, k, n, offset, pair):
    """The wgmma kernel's edges: M off its 128-row pairs and N off its
    256-column tiles, K off its 32-deep slabs and odd, one row and one
    column; A as a column slice one element in (``offset`` 1: an odd or
    even row stride k + 1 and a pointer off 8 bytes), in every (input,
    output) dtype pair."""
    a = _rand((m, k + offset), pair[0], m + k, cuda)[:, offset:]
    b = _rand((k, n), pair[0], n, cuda)
    out = DTYPES[pair[1]]
    before = tiled_matmul_cuda.launches
    got = tiled_matmul_cuda(a, b, out)
    assert tiled_matmul_cuda.launches == before + 1
    assert got.shape == (m, n) and got.dtype == out
    _close(got, tiled_matmul_plain(a, b, out), _pair_name(pair), k)


@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids="-".join)
@pytest.mark.parametrize("k", [2049, 13312, 32768])
def test_tiled_matmul_split_kernel_long_k(cuda, k, pair):
    """Long sums: an fp32 C takes the accumulator's sum in parts of
    K = 2048 (one part and a 1-deep rest, 6.5 parts, 16 parts), held at
    the reference's tolerance.  With one accumulator over all of K the
    fp32 case at K = 32768 misses the hold on an H100."""
    a = _rand((192, k), pair[0], k, cuda)
    b = _rand((k, 300), pair[0], k + 1, cuda)
    out = DTYPES[pair[1]]
    got = tiled_matmul_cuda(a, b, out)
    _close(got, tiled_matmul_plain(a, b, out), _pair_name(pair), k)


def _map(mask: np.ndarray, cuda) -> torch.Tensor:
    csr = block_csr_from_mask(mask)
    return torch.as_tensor(csr.padded_cols(max(csr.max_row_nnz, 1)),
                           dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids="-".join)
@pytest.mark.parametrize("bk", [8, 32, 256])
@pytest.mark.parametrize("bm", [32, 64, 96, 256])
def test_bsmm_split_kernel_blocks(cuda, bm, bk, pair):
    """Block rows of one short unit (32), one unit (64), a full and a
    short unit (96) and two pairs (256); blocks of 8 k (a quarter of a
    slab), one slab and eight; a block row with no live block, and N off
    the 256-column tile, in every dtype pair."""
    mb, kb, n = 4, 6, 300
    mask = random_block_mask(mb, kb, 0.5, seed=bm + bk)
    mask[2] = False
    a = _rand((mb * bm, kb * bk), pair[0], bm, cuda)
    b = _rand((kb * bk, n), pair[0], bk, cuda)
    cols, out = _map(mask, cuda), DTYPES[pair[1]]
    before = bsmm_cuda.launches
    got = bsmm_cuda(a, b, cols, bm=bm, bk=bk, bn=4, out_dtype=out)
    assert bsmm_cuda.launches == before + 1
    assert got.shape == (mb * bm, n) and got.dtype == out
    _close(got, bsmm_plain(a, b, cols, bm=bm, bk=bk, bn=4, out_dtype=out),
           _pair_name(pair), kb * bk)
    assert torch.all(got[2 * bm:3 * bm] == 0)


@pytest.mark.parametrize("bm,bk", [(256, 256), (96, 8)])
def test_bsmm_split_kernel_walk_ends_past_k(cuda, bm, bk):
    """A row's walk ends at an entry at or past K/bk even with live-looking
    entries after it: the kernel reads the map as the plain version does."""
    kb = 5
    a = _rand((3 * bm, kb * bk), "float32", 3, cuda)
    b = _rand((kb * bk, 260), "float32", 4, cuda)
    cols = torch.tensor([[1, 4, 5, 0], [3, 9, 2, -1], [7, 0, 1, 2]],
                        dtype=torch.int32, device=cuda)
    kept = torch.tensor([[1, 4, -1, -1], [3, -1, -1, -1],
                         [-1, -1, -1, -1]], dtype=torch.int32, device=cuda)
    got = bsmm_cuda(a, b, cols, bm=bm, bk=bk, bn=4)
    _close(got, bsmm_plain(a, b, kept, bm=bm, bk=bk, bn=4), "float32",
           kb * bk)
    assert torch.all(got[2 * bm:] == 0)


@pytest.mark.parametrize("name", list(DTYPES))
def test_bsmm_split_kernel_empty_map(cuda, name):
    """A column map with no entries (S = 0, whose data pointer may be
    null) stores zeros in every row: it is not read as the dense
    product's map-less launch."""
    a = _rand((128, 512), name, 5, cuda)
    b = _rand((512, 300), name, 6, cuda)
    cols = torch.zeros((2, 0), dtype=torch.int32, device=cuda)
    before = bsmm_cuda.launches
    got = bsmm_cuda(a, b, cols, bm=64, bk=256, bn=4)
    assert bsmm_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == (128, 300) and torch.all(got == 0)
    _close(got, bsmm_plain(a, b, cols, bm=64, bk=256, bn=4), name, 512)


@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids="-".join)
def test_bsmm_split_kernel_long_row(cuda, pair):
    """The main path's longest block row: 52 live (256 x 256) blocks, a
    K of 13312, at the reference's tolerance; an fp32 C takes the sum in
    parts of K = 2048 (``kSumSlabs``), a bf16 C in one accumulator."""
    bm = bk = 256
    mask = np.ones((2, 52), bool)
    mask[1, ::2] = False
    a = _rand((2 * bm, 52 * bk), pair[0], 52, cuda)
    b = _rand((52 * bk, 512), pair[0], 53, cuda)
    cols, out = _map(mask, cuda), DTYPES[pair[1]]
    got = bsmm_cuda(a, b, cols, bm=bm, bk=bk, bn=256, out_dtype=out)
    _close(got, bsmm_plain(a, b, cols, bm=bm, bk=bk, bn=256, out_dtype=out),
           _pair_name(pair), 52 * bk)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("fill", [0.1, 0.3, 0.7])
@pytest.mark.parametrize("bm", [64, 128, 256])
def test_bsmm_split_kernel_tile_map(cuda, bm, fill, name):
    """A map a block row and 256-column tile (``tile_lists``): the kernel
    against the plain version on the same map, bm = bk, N = 812 off the
    tile.  Every dead block of A and every block of B that no list of its
    tile names holds NaN, so a finite C shows they are never read.  Block
    row 0 is live throughout and tile 0's B too, so its list sums K = 3072
    (past the fp32 parts of K = 2048); tile 2's B is dead (every list
    empty: zero columns) and so is the last block row of A."""
    bk, mb, n = bm, 3, 812
    kb = 3072 // bk
    rng = np.random.default_rng(bm + int(fill * 10))
    a_mask = rng.random((mb, kb)) < fill
    a_mask[0], a_mask[-1] = True, False
    live = rng.random((kb, 4)) < fill
    live[:, 0], live[:, 2] = True, False
    cols = np.full((mb, kb), -1, np.int32)
    for i in range(mb):
        row = np.flatnonzero(a_mask[i])
        cols[i, :len(row)] = row
    tiles = tile_lists(cols, live)
    read = np.zeros((kb, n), bool)
    for t in range(4):
        read[:, 256 * t:256 * (t + 1)] = (live[:, t] & a_mask.any(0))[:, None]
    a = _rand((mb * bm, kb * bk), name, bm, cuda)
    b = _rand((kb * bk, n), name, bm + 1, cuda)
    nan = torch.tensor(float("nan"), dtype=a.dtype, device=cuda)
    a = torch.where(torch.as_tensor(np.kron(a_mask, np.ones((bm, bk), bool)),
                                    device=cuda), a, nan)
    b = torch.where(torch.as_tensor(np.repeat(read, bk, axis=0),
                                    device=cuda), b, nan)
    t_map = torch.as_tensor(tiles, device=cuda)
    before = bsmm_cuda.launches
    got = bsmm_cuda(a, b, t_map, bm=bm, bk=bk, bn=4)
    assert bsmm_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, bsmm_plain(a, b, t_map, bm=bm, bk=bk, bn=4), name, kb * bk)
    assert torch.all(got[:, 512:768] == 0) and torch.all(got[-bm:] == 0)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "t,d,f,e,bt",
    [(256, 64, 96, 4, 64), (512, 128, 64, 8, 128), (64, 32, 40, 3, 8),
     (72, 48, 100, 5, 24)],
)
def test_grouped_gemm_kernel_matches_plain(cuda, t, d, f, e, bt, name):
    """The reference's shapes, tiles of 8 and 24 rows (shorter than the
    kernel's 64-row tile) and a ragged F."""
    x, w = _rand((t, d), name, t, cuda), _rand((e, d, f), name, e, cuda)
    te = np.random.default_rng(bt).integers(0, e, size=t // bt).astype(
        np.int32)
    before = grouped_gemm_cuda.launches
    got = grouped_gemm_cuda(x, w, te, bt=bt)
    assert grouped_gemm_cuda.launches == before + 1
    assert got.shape == (t, f) and got.dtype == x.dtype
    want = grouped_gemm_plain(x, w, te, bt=bt)
    _close(got, want, name, d)
    _close(ops.grouped_gemm(x, w, te, bt=bt), want, name, d)


def test_grouped_gemm_kernel_strided_experts_and_bad_maps(cuda):
    """Experts read in place as the K-panels of one row-major B, tokens as
    a column slice; an out-of-range expert map is refused on the host, and
    the wrapper refuses a map on the card (it builds its work list from
    the host's)."""
    b = _rand((4 * 32, 200), "float32", 3, cuda)
    w = b.view(4, 32, 200)
    x = _rand((64, 96), "float32", 4, cuda)[:, 40:72]
    te = np.array([3, 0, 0, 2, 1, 3, 2, 1], np.int32)
    got = ops.grouped_gemm(x, w, te, bt=8, out_dtype=torch.float32)
    _close(got, grouped_gemm_plain(x, w, torch.as_tensor(te), bt=8),
           "float32", 32)
    with pytest.raises(ValueError, match="expert"):
        ops.grouped_gemm(x, w, np.full(8, 4, np.int32), bt=8)
    with pytest.raises(TypeError, match="dtypes differ"):
        grouped_gemm_cuda(x, w.bfloat16(), te, bt=8)
    with pytest.raises(ValueError, match="on the host"):
        grouped_gemm_cuda(x, w, torch.as_tensor(te, device=cuda), bt=8)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "bt,counts,f",
    [(64, (8, 8, 8, 8), 600), (64, (3, 5, 1), 512), (8, (5, 2, 4), 300),
     (24, (3, 4), 260), (128, (3, 2), 256)],
)
def test_grouped_gemm_split_kernel(cuda, bt, counts, f, name):
    """The wgmma kernel at the main path's D = 256: 8 tiles an expert (4
    full pairs), odd tile counts (a block whose second consumer idles),
    tiles of 8 and 24 rows (one short unit) and of 128 (two units), with
    the experts read in place as the K-panels of one row-major B, tokens
    as a column slice, and a ragged F (not a multiple of the 256-column
    tile; F = 300 and 260 also leave bf16 rows off 16 bytes).  Through
    ``ops`` and through the wrapper directly (the map on the host)."""
    d = 256
    rng = np.random.default_rng(bt + f)
    te = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    rng.shuffle(te)
    t = te.size * bt
    w = _rand((len(counts) * d, f), name, f, cuda).view(len(counts), d, f)
    x = _rand((t, d + 40), name, t, cuda)[:, 40:]
    want = grouped_gemm_plain(x, w, torch.as_tensor(te, device=cuda), bt=bt)
    before = grouped_gemm_cuda.launches
    got = ops.grouped_gemm(x, w, te, bt=bt)
    assert grouped_gemm_cuda.launches == before + 1
    assert got.shape == (t, f) and got.dtype == x.dtype
    _close(got, want, name, d)
    got = grouped_gemm_cuda(x, w, te, bt=bt, out_dtype=torch.float32)
    _close(got, want.float() if name == "float32" else
           grouped_gemm_plain(x, w, torch.as_tensor(te, device=cuda), bt=bt,
                              out_dtype=torch.float32), name, d)


@pytest.mark.parametrize("name", list(DTYPES))
def test_grouped_gemm_split_kernel_column_slice(cuda, name):
    """Experts as a column slice of a wider buffer: the row stride (304)
    allows 16-byte copies, and each row's last copy (F = 300) is a
    partial one, zero-filled past F."""
    d, f, bt = 256, 300, 64
    te = np.array([1, 0, 1, 1, 0], np.int32)
    w = _rand((2, d, 304), name, 7, cuda)[:, :, :f]
    x = _rand((te.size * bt, d), name, 8, cuda)
    got = ops.grouped_gemm(x, w, te, bt=bt)
    _close(got, grouped_gemm_plain(x, w, torch.as_tensor(te, device=cuda),
                                   bt=bt), name, d)


@pytest.mark.parametrize("name", list(DTYPES))
def test_ranksparse_matmul_on_the_card(cuda, name):
    """The single-launch local rank route against its densified oracle;
    a bf16 B is promoted to the fp32 factors' type."""
    rcsr = synthesize_rank_csr(
        decay_rank_map(4, 4, 32, 32, max_rank=8, decay=0.8), seed=5
    )
    b = _rand((128, 96), name, 5, cuda)
    before = grouped_gemm_cuda.launches
    got = ops.ranksparse_matmul(rcsr, b)
    assert grouped_gemm_cuda.launches == before + 1
    a = torch.from_numpy(rcsr.to_dense()).to(cuda)
    _close(got, torch.matmul(a, b.float()), name, 128)


def _heads_view(b, s, h, dh, name, seed, device):
    """A (B, H, S, Dh) transposed view of a (B, S, H, Dh) tensor, as the
    attention layer hands the kernel."""
    return _rand((b, s, h, dh), name, seed, device).transpose(1, 2)


def _close_attention(got, want, name):
    tol = 2e-2 if name == "bfloat16" else 2e-3
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "h,hkv,s,causal,window",
    [(4, 2, 256, True, None), (4, 1, 256, True, 64), (2, 2, 128, False, None),
     (8, 4, 512, True, 128), (2, 2, 256, True, 8), (4, 2, 1000, True, None),
     (4, 2, 1000, False, 100)],
)
def test_flash_attention_kernel_matches_plain(cuda, h, hkv, s, causal, window,
                                              name):
    """The reference's shapes, the window-8 case, and a ragged S = 1000."""
    q = _heads_view(2, s, h, 64, name, h * s, cuda)
    k = _heads_view(2, s, hkv, 64, name, hkv, cuda)
    v = _heads_view(2, s, hkv, 64, name, hkv + 1, cuda)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert flash_attention_cuda.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    _close_attention(got, want, name)
    # the wrapper launches the kernel for any S, whatever its tile
    _close_attention(ops.flash_attention(q, k, v, causal=causal,
                                         window=window, bq=128, bk=128),
                     want, name)
    assert flash_attention_cuda.launches == before + 2


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("dh", [128, 256])
def test_flash_attention_kernel_wide_heads(cuda, dh, name):
    """Dh 128 (qwen, command-r) and 256 (gemma, key tiles of 32)."""
    q = _rand((1, 4, 300, dh), name, dh, cuda)
    k = _rand((1, 1, 300, dh), name, dh + 1, cuda)
    v = _rand((1, 1, 300, dh), name, dh + 2, cuda)
    for causal, window in ((True, None), (True, 40), (False, None)):
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        _close_attention(got, flash_attention_plain(
            q, k, v, causal=causal, window=window), name)


def test_flash_attention_kernel_dead_rows_and_refusals(cuda):
    """Sk = 64 < Sq = 256 without a causal mask, window 64: rows 127 and
    up have no live key and are 0, as in the plain version."""
    q = _rand((1, 2, 256, 64), "float32", 1, cuda)
    k = _rand((1, 2, 64, 64), "float32", 2, cuda)
    v = _rand((1, 2, 64, 64), "float32", 3, cuda)
    got = flash_attention_cuda(q, k, v, causal=False, window=64)
    torch.cuda.synchronize()
    assert torch.all(got[:, :, 127:] == 0)
    assert torch.all(torch.isfinite(got))
    _close_attention(got, flash_attention_plain(q, k, v, causal=False,
                                                window=64), "float32")
    with pytest.raises(ValueError, match="head widths"):
        wide = _rand((1, 2, 64, 320), "float32", 5, cuda)
        flash_attention_cuda(wide, wide, wide)
    every_other = _rand((1, 2, 256, 128), "float32", 4, cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention_cuda(every_other, k, v)



def _close_bf16_attention(got, want):
    """bf16 attention held as ``chip_smoke.py`` holds it: each element
    within 2e-2 (the reference's tolerance) and within one bf16 ulp of
    ``want`` (2**-7 |want|) plus 2e-2 rms(want) (fp32 noise and the bf16
    rounding of P before P V)."""
    _close_attention(got, want, "bfloat16")
    g, w = got.float(), want.float()
    limit = 2 ** -7 * w.abs() + 2e-2 * w.square().mean().sqrt()
    worst = ((g - w).abs() / limit).max().item()
    assert worst <= 1, f"worst element at {worst:.3g} of its limit"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 127, 128, 129, 255, 1000])
def test_flash_attention_bf16_tile_edges(cuda, s, causal):
    """Lengths on both sides of the bf16 kernel's 128-row query tile (two
    of its 64-key tiles)."""
    q = _heads_view(2, s, 4, 64, "bfloat16", s, cuda)
    k = _heads_view(2, s, 2, 64, "bfloat16", s + 1, cuda)
    v = _heads_view(2, s, 2, 64, "bfloat16", s + 2, cuda)
    got = flash_attention_cuda(q, k, v, causal=causal)
    _close_bf16_attention(got, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize(
    "sq,sk,causal,window",
    [(200, 700, False, None), (130, 1000, True, None), (256, 64, False, 64),
     (300, 129, False, None), (1000, 200, True, 50)],
)
def test_flash_attention_bf16_unequal_lengths(cuda, sq, sk, causal, window):
    """Sq != Sk; with Sk = 64 < Sq = 256, no causal mask and window 64,
    rows 127 and up have no live key and are 0."""
    q = _heads_view(1, sq, 4, 64, "bfloat16", sq, cuda)
    k = _heads_view(1, sk, 2, 64, "bfloat16", sk, cuda)
    v = _heads_view(1, sk, 2, 64, "bfloat16", sk + 1, cuda)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    _close_bf16_attention(got, want)
    if (sq, sk, window) == (256, 64, 64):
        assert torch.all(got[:, :, 127:] == 0)
        assert torch.all(got[:, :, :127].abs().sum(-1) > 0)


@pytest.mark.parametrize("h,hkv", [(10, 2), (40, 8), (16, 2), (8, 1)])
def test_flash_attention_bf16_gqa_groups(cuda, h, hkv):
    """Head groups of 5 (qwen2.5-32b's 40/8) and of 8."""
    q = _heads_view(2, 300, h, 64, "bfloat16", h, cuda)
    k = _heads_view(2, 300, hkv, 64, "bfloat16", hkv, cuda)
    v = _heads_view(2, 300, hkv, 64, "bfloat16", hkv + 1, cuda)
    got = flash_attention_cuda(q, k, v, causal=True)
    _close_bf16_attention(got, flash_attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize("window", [8, 200])
@pytest.mark.parametrize("dh", [128, 256])
def test_flash_attention_bf16_wide_heads_windows(cuda, dh, window):
    """Dh 128 (two 64-column boxes a row) and 256 (four) under sliding
    windows narrower and wider than a 64-key tile."""
    q = _heads_view(2, 700, 4, dh, "bfloat16", dh, cuda)
    k = _heads_view(2, 700, 2, dh, "bfloat16", dh + 1, cuda)
    v = _heads_view(2, 700, 2, dh, "bfloat16", dh + 2, cuda)
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    _close_bf16_attention(got, flash_attention_plain(q, k, v, causal=True,
                                                     window=window))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("dh", [8, 32, 80, 112])
def test_flash_attention_kernel_every_head_width(cuda, dh, name):
    """Head widths off the kernel's instances (8: llama, qwen and
    command-r smoke; 32: gemma smoke; 80: hubert-xlarge; 112: kimi-k2):
    the next instance's columns past Dh read as zero and are not stored.
    Causal with GQA, under windows narrower and wider than a key tile,
    and without a mask, on transposed views."""
    q = _heads_view(2, 300, 8, dh, name, dh, cuda)
    k = _heads_view(2, 300, 2, dh, name, dh + 1, cuda)
    v = _heads_view(2, 300, 2, dh, name, dh + 2, cuda)
    for causal, window in ((True, None), (True, 8), (True, 100),
                           (False, None)):
        before = flash_attention_cuda.launches
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        assert flash_attention_cuda.launches == before + 1
        assert got.shape == q.shape and got.dtype == q.dtype
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        if name == "bfloat16":
            _close_bf16_attention(got, want)
        else:
            _close_attention(got, want, name)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("dh", [1, 33])
def test_flash_attention_kernel_odd_head_widths(cuda, dh, name):
    """Odd widths: the last column is stored alone, and the output rows
    (``empty_like`` of a non-dense view is contiguous, row stride Dh) are
    not 4-byte aligned.  bf16 operands are Dh-column views of a buffer
    whose rows are padded to 16 bytes, the strides TMA can read."""
    def operand(h, seed):
        x = _heads_view(1, 200, h, -(-dh // 8) * 8, name, seed, cuda)
        return x[..., :dh]

    q, k, v = operand(4, dh), operand(2, dh + 1), operand(2, dh + 2)
    for causal, window in ((True, None), (False, 50)):
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        assert got.shape == q.shape
        if name == "bfloat16":
            _close_bf16_attention(got, want)
        else:
            _close_attention(got, want, name)


def test_flash_attention_bf16_refuses_what_tma_cannot_read(cuda):
    """A view one element off a 16-byte boundary, and a sequence stride of
    136 bytes: ValueErrors naming the condition, no launch."""
    flat = _rand((2 * 64 * 4 * 64 + 1,), "bfloat16", 5, cuda)
    shifted = flat[1:].view(2, 64, 4, 64).transpose(1, 2)
    k = _heads_view(2, 64, 2, 64, "bfloat16", 6, cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="q.data_ptr.. is not 16-byte aligned"):
        flash_attention_cuda(shifted, k, k)
    padded = _rand((2, 2, 64, 68), "bfloat16", 7, cuda)[..., :64]
    with pytest.raises(ValueError, match="sequence stride of 136 bytes"):
        flash_attention_cuda(shifted.contiguous(), padded, k)
    assert flash_attention_cuda.launches == before

@pytest.mark.parametrize(
    "arch", ["llama3.2-1b", "gemma-2b", "qwen2.5-32b", "command-r-35b"])
def test_smoke_config_forward_through_the_kernel(cuda, arch):
    """Each ported config's smoke variant as it is (head widths 8 and
    32, bf16) and widened to fp32, through ``use_kernel=True``: one launch
    per layer, logits near the plain-attention forward's (fp32 1e-3 of max
    |logit|; bf16 8e-2, chip_smoke.py's bound for two bf16 forwards that
    differ only in the order of fp32 sums)."""
    for dtype, rel in (("bfloat16", 8e-2), ("float32", 1e-3)):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        model = init_model(cfg, generator=torch.Generator(cuda).manual_seed(0),
                           device=cuda)
        tokens = torch.randint(0, cfg.vocab_size, (2, 130), device=cuda,
                               generator=torch.Generator(cuda).manual_seed(1))
        before = flash_attention_cuda.launches
        got, _ = forward(model, {"tokens": tokens}, cfg, ParallelCtx(None),
                         use_kernel=True)
        assert flash_attention_cuda.launches == before + cfg.num_layers
        want, _ = forward(model, {"tokens": tokens}, cfg, ParallelCtx(None))
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=rel * scale)


def test_lm_forward_through_the_kernel_on_the_card(cuda):
    """A narrow llama (2 layers, Dh 64) on the card: one kernel launch per
    layer, logits near the plain-attention forward's (fp32)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              head_dim=64, dtype="float32")
    model = init_model(cfg, generator=torch.Generator(cuda).manual_seed(0),
                       device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    before = flash_attention_cuda.launches
    got, _ = forward(model, {"tokens": tokens}, cfg, ParallelCtx(None),
                     use_kernel=True)
    assert flash_attention_cuda.launches == before + cfg.num_layers
    want, _ = forward(model, {"tokens": tokens}, cfg, ParallelCtx(None))
    assert flash_attention_cuda.launches == before + cfg.num_layers
    scale = want.abs().max().item()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3 * scale)


#: the nonuniform product's padded extents at tile 256 (N = 32768, seeds
#: 0/1/2): rows, inner, cols
NONUNIFORM_EXTENTS = (47872, 47360, 47616)


@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids="-".join)
@pytest.mark.parametrize("k", [256, 47360])
def test_tiled_matmul_split_kernel_nonuniform_panel(cuda, k, pair):
    """The nonuniform product's shapes, M cut to three 128-row pairs: a
    256-wide K-panel of A read as a column slice with row stride 47360
    (≠ K) against the full 47616 columns of B, and the whole K = 47360 of
    the one product a tuned all-gather schedule issues."""
    m = 384
    _, inner, cols = NONUNIFORM_EXTENTS
    a = _rand((m, inner), pair[0], 19, cuda)[:, inner - k:]
    assert a.stride(0) == inner
    b = _rand((k, cols if k == 256 else 300), pair[0], 20, cuda)
    out = DTYPES[pair[1]]
    got = tiled_matmul_cuda(a, b, out)
    _close(got, tiled_matmul_plain(a, b, out), _pair_name(pair), k)


@pytest.mark.parametrize("name", list(DTYPES))
def test_bsmm_split_kernel_nonuniform_extents(cuda, name):
    """``bsmm`` over the nonuniform inner extent, 185 block columns of 256
    at fill 0.3, M cut to three 128-row blocks and N to 520."""
    m, inner, n = 384, NONUNIFORM_EXTENTS[1], 520
    mask = random_block_mask(m // 128, inner // 256, 0.3, seed=4)
    a = _rand((m, inner), name, 21, cuda)
    b = _rand((inner, n), name, 22, cuda)
    cols = _map(mask, cuda)
    before = bsmm_cuda.launches
    got = bsmm_cuda(a, b, cols, bm=128, bk=256, bn=n)
    assert bsmm_cuda.launches == before + 1
    _close(got, bsmm_plain(a, b, cols, bm=128, bk=256, bn=n), name,
           int(mask.sum(axis=1).max()) * 256)


def test_autotuner_times_each_kernel_on_the_card(cuda):
    """``KernelAutotuner.tune`` on the 128 bucket launches every route's
    kernel and records a winner among the routes it timed, measured on
    this card's kind; the CPU refuses the table."""
    from repro_torch.kernels.autotune import KernelAutotuner

    counters = (tiled_matmul_cuda, bsmm_cuda, grouped_gemm_cuda)
    before = [fn.launches for fn in counters]
    tuner = KernelAutotuner()
    entry = tuner.tune(128, 128, 128, repeats=2, device=cuda)
    assert all(fn.launches > n for fn, n in zip(counters, before))
    assert set(entry["times_s"]) == {"xla", "pallas", "bsmm", "grouped"}
    assert entry["winner"] in entry["times_s"]
    assert entry["tiles"] == [128, 128, 128]
    assert tuner.device_kind == torch.cuda.get_device_name(cuda)
    assert tuner.winner(100, 120, 128, device=cuda) == entry["winner"]
    with pytest.raises(ValueError, match="not on cpu"):
        tuner.lookup(100, 120, 128, device="cpu")


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("bm,bk,bn", [(16, 12, 80), (32, 12, 80),
                                      (12, 16, 40), (8, 6, 32), (6, 20, 24)])
def test_bsmm_split_kernel_small_blocks(cuda, bm, bk, bn, name):
    """The contraction front-end's blocks (6 to 32 wide, the contraction
    oracle's families): block rows shorter than a 64-row unit, k-slabs
    past the block zero-filled, A rows of an odd stride."""
    mb, kb = 5, 7
    mask = random_block_mask(mb, kb, 0.5, seed=bm + bk)
    a = _rand((mb * bm, kb * bk), name, 23, cuda)
    b = _rand((kb * bk, bn), name, 24, cuda)
    cols = _map(mask, cuda)
    got = bsmm_cuda(a, b, cols, bm=bm, bk=bk, bn=bn)
    _close(got, bsmm_plain(a, b, cols, bm=bm, bk=bk, bn=bn), name, kb * bk)


def test_contract_on_the_card_equals_eager_and_the_cpu(cuda):
    """A small particle-particle ladder through ``DistributedMatmul.
    contract`` on the card: one ``bsmm`` launch, compiled equal to eager
    bitwise, and both within the fp32 hold of the CPU route."""
    from repro_torch.core import BlockSparseTensor, DistributedMatmul, Grid
    from repro_torch.core.blocking import uniform_tiling

    o, v, blk = 8, 24, 4
    ts = []
    for shape, fill, seed in (((o, o, v, v), 0.5, 0), ((v,) * 4, 0.3, 1)):
        mask = np.random.default_rng(seed).random(
            tuple(d // blk for d in shape)) < fill
        ts.append(BlockSparseTensor(
            _rand(shape, "float32", seed + 30, "cpu"),
            tuple(uniform_tiling(d, blk) for d in shape), mask=mask))
    spec = "ijab,abcd->ijcd"
    outs = {}
    for compiled in (True, False):
        mm = DistributedMatmul(Grid.local(cuda), local_matmul="pallas",
                               compiled=compiled)
        before = bsmm_cuda.launches
        outs[compiled] = mm.contract(spec, *ts).data
        assert bsmm_cuda.launches == before + 1
        assert outs[compiled].device.type == "cuda"
    assert torch.equal(outs[True], outs[False])
    cpu = DistributedMatmul(Grid.local("cpu"), local_matmul="pallas")
    _close(outs[True], cpu.contract(spec, *ts).data, "float32", v * v)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("bt,d,f", [(112, 256, 300), (64, 256, 512),
                                    (1280, 128, 256)])
def test_grouped_gemm_host_map_launch(cuda, bt, d, f, name):
    """The map on the host, as the MoE layer gives it, at tiles of 112
    rows (kimi-k2's capacity at 4096 tokens: a 64-row unit and a 48-row
    one) and of 1280 (mixtral's): through ``ops.grouped_gemm`` and the
    wrapper directly, one launch each, equal bitwise, and held against
    the plain version."""
    e = 3
    te = np.tile(np.arange(e, dtype=np.int32), 2)
    x = _rand((te.size * bt, d), name, bt, cuda)
    w = _rand((e, d, f), name, f, cuda)
    before = grouped_gemm_cuda.launches
    got = ops.grouped_gemm(x, w, te, bt=bt)
    assert grouped_gemm_cuda.launches == before + 1
    direct = grouped_gemm_cuda(x, w, te, bt=bt)
    assert grouped_gemm_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, direct)
    _close(got, grouped_gemm_plain(x, w, te, bt=bt), name, d)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_layer_on_the_card(cuda, arch):
    """A SMOKE MoE layer on the card: ``use_kernel=True`` launches the
    grouped GEMM three times (gate, up, down) and agrees with the einsum
    route within one bf16 rounding of each value (2**-7 of |want|) and
    2e-2 of the output's rms."""
    from repro_torch.models import moe

    cfg = get_config(arch, smoke=True)
    layer = moe.init_moe(cfg, generator=torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    x = _rand((2, 64, cfg.d_model), "bfloat16", 3, cuda)
    before = grouped_gemm_cuda.launches
    got, aux = moe.moe_ffn(layer, x, cfg, ParallelCtx(None), use_kernel=True)
    assert grouped_gemm_cuda.launches == before + 3
    want, want_aux = moe.moe_ffn(layer, x, cfg, ParallelCtx(None))
    torch.cuda.synchronize()
    want = want.float()
    rms = want.square().mean().sqrt().item()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=2.0 ** -7,
                               atol=2e-2 * rms)
    assert float(aux) == float(want_aux)
