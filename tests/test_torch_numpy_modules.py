"""The port's numpy modules against the reference's: equal outputs for
equal seeds (``core.sparsity``, ``spgemm.structure``,
``spgemm.stationarity``, ``configs.paper_mm``)."""
import numpy as np
import pytest
import torch

import repro.configs.paper_mm as ref_mm
import repro.core.sparsity as ref_sp
import repro.spgemm as ref_spgemm
import repro_torch.configs.paper_mm as port_mm
import repro_torch.core.sparsity as port_sp
import repro_torch.spgemm as port_spgemm
from repro.sched.taskgraph import BCAST_FACTOR as REF_BCAST_FACTOR
from repro_torch.core.api import pad_to_multiple
from repro_torch.sched.taskgraph import BCAST_FACTOR


def _same(x, y):
    """Deep equality over arrays, dataclasses, tuples and scalars."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype
    elif hasattr(x, "__dataclass_fields__"):
        assert type(x).__name__ == type(y).__name__
        for f in x.__dataclass_fields__:
            _same(getattr(x, f), getattr(y, f))
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y)
        for xi, yi in zip(x, y):
            _same(xi, yi)
    elif isinstance(x, dict):
        assert x.keys() == y.keys()
        for key in x:
            _same(x[key], y[key])
    else:
        assert x == y


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_mask_generators_match(seed):
    for mb, nb, fill in ((8, 8, 0.3), (4, 12, 0.1), (16, 4, 0.7)):
        _same(
            port_sp.random_block_mask(mb, nb, fill, seed=seed),
            ref_sp.random_block_mask(mb, nb, fill, seed=seed),
        )
    _same(port_sp.banded_block_mask(8, 6, seed % 3),
          ref_sp.banded_block_mask(8, 6, seed % 3))
    _same(port_sp.block_diag_block_mask(6, 6),
          ref_sp.block_diag_block_mask(6, 6))
    _same(port_sp.decay_block_mask(8, 8, decay=0.3 + seed / 10, threshold=0.05),
          ref_sp.decay_block_mask(8, 8, decay=0.3 + seed / 10, threshold=0.05))


@pytest.mark.parametrize("seed", [0, 5])
def test_block_csr_and_flops_match(seed):
    mask = ref_sp.random_block_mask(8, 8, 0.4, seed=seed)
    b_mask = ref_sp.random_block_mask(8, 6, 0.5, seed=seed + 1)
    port_csr = port_sp.block_csr_from_mask(mask)
    ref_csr = ref_sp.block_csr_from_mask(mask)
    _same(port_csr, ref_csr)
    _same(port_csr.padded_cols(), ref_csr.padded_cols())
    _same(port_csr.padded_cols(9), ref_csr.padded_cols(9))
    _same(port_csr.row_lengths(), ref_csr.row_lengths())
    _same(port_sp.mask_matmul_flops(mask, b_mask, 8, 16, 4),
          ref_sp.mask_matmul_flops(mask, b_mask, 8, 16, 4))


@pytest.mark.parametrize("seed", [0, 7])
def test_rank_structures_match(seed):
    kw = dict(max_rank=4, decay=0.6, threshold=2e-2)
    port_map = port_sp.decay_rank_map(6, 8, 16, 12, **kw)
    ref_map = ref_sp.decay_rank_map(6, 8, 16, 12, **kw)
    _same(port_map.ranks, ref_map.ranks)
    _same(port_sp.random_rank_map(6, 8, 16, 12, 0.5, max_rank=5, seed=seed).ranks,
          ref_sp.random_rank_map(6, 8, 16, 12, 0.5, max_rank=5, seed=seed).ranks)
    port_rk = port_sp.synthesize_rank_csr(port_map, seed=seed)
    ref_rk = ref_sp.synthesize_rank_csr(ref_map, seed=seed)
    _same(port_rk.u, ref_rk.u)
    _same(port_rk.v, ref_rk.v)
    _same(port_rk.ranks, ref_rk.ranks)
    _same(port_rk.to_dense(), ref_rk.to_dense())
    dense = ref_rk.to_dense()
    _same(port_sp.rank_csr_from_dense(dense, 16, 12).ranks,
          ref_sp.rank_csr_from_dense(dense, 16, 12).ranks)
    b_mask = ref_sp.random_block_mask(8, 5, 0.5, seed=seed)
    _same(port_sp.rank_matmul_flops(port_map, b_mask, 10),
          ref_sp.rank_matmul_flops(ref_map, b_mask, 10))
    _same(port_sp.rank_csr_norms(port_rk), ref_sp.rank_csr_norms(ref_rk))
    norms = port_sp.block_norms(dense, 6, 8)
    _same(norms, ref_sp.block_norms(dense, 6, 8))
    _same(port_sp.norms_key(norms), ref_sp.norms_key(norms))
    for r, bm, bk, bn in ((1, 16, 16, 32), (7, 16, 16, 32), (12, 32, 8, 4)):
        for fn in ("rank_panel_flops", "rank_panel_factored_compute",
                   "block_rank_flops"):
            _same(getattr(port_sp, fn)(r, bm, bk, bn),
                  getattr(ref_sp, fn)(r, bm, bk, bn))
        _same(port_sp.rank_panel_factored_comm(r, bm, bk),
              ref_sp.rank_panel_factored_comm(r, bm, bk))


@pytest.mark.parametrize("seed", [0, 2, 9])
def test_spgemm_structure_and_stationarity_match(seed):
    rng = np.random.default_rng(seed)
    a = ref_sp.random_block_mask(6, 8, 0.4, seed=seed)
    b = ref_sp.random_block_mask(8, 5, 0.4, seed=seed + 1)
    ranks = ref_sp.decay_rank_map(6, 8, 16, 12, max_rank=4, decay=0.6)
    port_ranks = port_sp.BlockRankMap(ranks=ranks.ranks, bm=16, bk=12)
    _same(port_spgemm.output_mask(a, b), ref_spgemm.output_mask(a, b))
    _same(port_spgemm.output_mask(None, b, m_blocks=3),
          ref_spgemm.output_mask(None, b, m_blocks=3))
    _same(port_spgemm.output_rank_bound(port_ranks, b),
          ref_spgemm.output_rank_bound(ranks, b))
    _same(port_spgemm.live_elems(port_ranks, (96, 96)),
          ref_spgemm.live_elems(ranks, (96, 96)))
    _same(port_spgemm.live_elems(a, (96, 96)), ref_spgemm.live_elems(a, (96, 96)))
    an = rng.uniform(0.0, 1.0, (6, 8)) * a
    bn = rng.uniform(0.0, 1.0, (8, 5)) * b
    eps = 0.2 * float((an[:, :, None] * bn[None]).max())
    _same(port_spgemm.filter_keep(an, bn, eps), ref_spgemm.filter_keep(an, bn, eps))
    keep, _ = ref_spgemm.filter_keep(an, bn, eps)
    _same(port_spgemm.output_norms(an, bn, keep),
          ref_spgemm.output_norms(an, bn, keep))
    for p_row, p_col in ((1, 1), (2, 2), (4, 1), (2, 4)):
        kw = dict(m=96, k=96, n=60, p_row=p_row, p_col=p_col, itemsize=4)
        _same(port_spgemm.choose_stationarity(a, b, **kw),
              ref_spgemm.choose_stationarity(a, b, **kw))
        _same(port_spgemm.stationarity_comm_volumes(port_ranks, b, **kw),
              ref_spgemm.stationarity_comm_volumes(ranks, b, **kw))
    assert BCAST_FACTOR == REF_BCAST_FACTOR


def test_paper_configs_match():
    assert port_mm.PAPER_MATRIX_SIZES == ref_mm.PAPER_MATRIX_SIZES
    assert port_mm.COMMODITY_N == ref_mm.COMMODITY_N
    assert port_mm.COMMODITY_BLOCK == ref_mm.COMMODITY_BLOCK
    cfg = port_mm.MMConfig(n=port_mm.COMMODITY_N, block=port_mm.COMMODITY_BLOCK)
    assert cfg.num_blocks == ref_mm.MMConfig(n=32_768, block=256).num_blocks


@pytest.mark.parametrize("fill", [0.3, 1.0])
def test_make_case_is_seeded_and_fill_independent(fill):
    a, b, a_mask, b_mask = port_mm.make_case(256, 32, fill, seed=4)
    a2, b2, _, _ = port_mm.make_case(256, 32, 0.5, seed=4)
    assert a.shape == b.shape == (256, 256) and a.dtype == np.float32
    np.testing.assert_array_equal(a, a2)  # operands do not depend on fill
    np.testing.assert_array_equal(b, b2)
    assert not np.array_equal(a, b)
    _same(a_mask, ref_sp.random_block_mask(8, 8, fill, seed=5))
    _same(b_mask, ref_sp.random_block_mask(8, 8, fill, seed=6))
    with pytest.raises(ValueError):
        port_mm.make_case(100, 32, fill)


def test_pad_to_multiple():
    x = torch.arange(12.0).reshape(3, 4)
    y = pad_to_multiple(x, (4, 3))
    assert y.shape == (4, 6)
    assert torch.equal(y[:3, :4], x) and y[3:].abs().sum() == 0
    assert pad_to_multiple(x, (3, 2)) is x
