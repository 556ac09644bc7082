"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  The file imports neither ``jax`` nor
``repro``, so it runs on a GPU machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Shapes and tolerances are those of ``tests/test_kernels.py`` (fp32 1e-4,
bf16 2e-2, atol scaled by sqrt(K)).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import block_csr_from_mask, random_block_mask
from repro_torch.kernels import ops
from repro_torch.kernels.bsmm import bsmm_cuda, bsmm_plain
from repro_torch.kernels.tiled_matmul import tiled_matmul_cuda, tiled_matmul_plain

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
        bsmm_cuda(a, b, bad, bm=32, bk=32, bn=32)
    with pytest.raises(ValueError, match="contiguous"):
        bsmm_cuda(a.t(), b, bad.clamp(max=0), bm=32, bk=32, bn=32)
    with pytest.raises(ValueError, match="unit column stride"):
        tiled_matmul_cuda(a.t(), b)
