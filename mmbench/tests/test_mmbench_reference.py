"""The plain reference and its comparison against float64 NumPy."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mmbench import cases, reference


def _kron(x: np.ndarray, mask: np.ndarray, block: int) -> np.ndarray:
    return x * np.kron(mask, np.ones((block, block)))


def test_mask_rows_matches_a_kronecker_mask():
    rng = np.random.default_rng(0)
    mask = rng.random((4, 4)) < 0.5
    x = torch.randn(32, 32, dtype=torch.float32)
    want = _kron(x.numpy().astype(np.float64), mask, 8)
    got = x.clone()
    reference.mask_rows_(got, mask, 8, 0, 32)
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    part = x.clone()
    reference.mask_rows_(part, mask, 8, 8, 16)
    assert torch.equal(part[8:16], got[8:16]) and torch.equal(part[:8], x[:8])
    with pytest.raises(ValueError):
        reference.mask_rows_(part, mask, 8, 4, 12)


def _numpy_products(n, block, seed, a_mask, b_mask, count):
    """Each product's C in float64 NumPy from independently masked
    operands, with B's bands redrawn as the window redraws them."""
    a = _kron(cases.operand(n, seed, cases.A_VALUES, "cpu").numpy()
              .astype(np.float64), a_mask, block)
    b_t = cases.operand(n, seed, cases.B_VALUES, "cpu")
    bands = cases.BandStream(n, block, seed, "cpu")
    out = []
    for _ in range(count):
        band = bands.redraw(b_t)
        c = a @ _kron(b_t.numpy().astype(np.float64), b_mask, block)
        out.append((band, c))
    return out


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_check_agrees_with_numpy_and_sees_a_wrong_block(seed):
    n, block = 64, 16
    a_mask = cases.random_block_mask(4, 4, 0.5, cases.host_rng(seed, cases.A_MASK))
    b_mask = cases.random_block_mask(4, 4, 0.5, cases.host_rng(seed, cases.B_MASK))
    x = cases.projection(n, seed, "cpu").numpy().astype(np.float64)
    rows = cases.RowStream(n, 8, seed)
    i, j = np.argwhere(a_mask.astype(int) @ b_mask.astype(int))[0]
    products = []
    for k, (band, c) in enumerate(_numpy_products(n, block, seed, a_mask,
                                                  b_mask, 4)):
        if k == 2:
            c = c.copy()
            c[i * block:(i + 1) * block, j * block:(j + 1) * block] = 0
        r = rows.next()
        products.append(reference.Product(
            band, r, torch.from_numpy(c[r].astype(np.float32)),
            torch.from_numpy((c @ x).astype(np.float32))))

    def ref_a():
        a = cases.operand(n, seed, cases.A_VALUES, "cpu")
        reference.mask_rows_(a, a_mask, block, 0, n)
        return a

    got = reference.check(
        products, n=n, seed=seed, device="cpu", band_rows=block,
        reference_a=ref_a,
        reference_b_rows=lambda b, lo, hi: reference.mask_rows_(b, b_mask, block,
                                                                lo, hi),
        limits={"rows_err": 1e-5, "proj_err": 1e-5})
    assert got["compared"] == 4 and got["failed"] == 1
    assert got["worst"]["proj_err"] > 1e-2


def test_tf32_rounding_keeps_ten_bits():
    x = torch.randn(10000, dtype=torch.float32)
    r = reference.round_tf32(x)
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 2.0**-13 < rel <= 2.0**-11
    assert torch.equal(reference.round_tf32(r), r)
