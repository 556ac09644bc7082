"""The frozen yardstick against brute force and against the program's
own makers and counts at the time of freezing."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from mmbench import cases, count, run


def _brute_triples(a, b):
    m, k = a.shape
    n = b.shape[1]
    return sum(1 for i, kk, j in itertools.product(range(m), range(k), range(n))
               if a[i, kk] and b[kk, j])


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
@pytest.mark.parametrize("fill", [0.1, 0.3, 1.0])
def test_useful_count_is_the_live_triples(seed, fill):
    a = cases.random_block_mask(6, 5, fill, cases.host_rng(seed, cases.A_MASK))
    b = cases.random_block_mask(5, 7, fill, cases.host_rng(seed, cases.B_MASK))
    triples = _brute_triples(a, b)
    assert count.live_triples(a, b) == triples
    assert count.blocksparse_flop(a, b, 16) == 2.0 * triples * 16 ** 3


def test_blocksparse_bytes_read_each_used_block_once():
    rng = np.random.default_rng(3)
    a, b = rng.random((5, 6)) < 0.4, rng.random((6, 4)) < 0.4
    a_used = {(i, k) for i, k, j in itertools.product(range(5), range(6), range(4))
              if a[i, k] and b[k, j]}
    b_used = {(k, j) for i, k, j in itertools.product(range(5), range(6), range(4))
              if a[i, k] and b[k, j]}
    c_live = {(i, j) for i, k, j in itertools.product(range(5), range(6), range(4))
              if a[i, k] and b[k, j]}
    blocks = len(a_used) + len(b_used) + len(c_live)
    assert count.blocksparse_bytes(a, b, 8) == blocks * 8 * 8 * 4


def test_dense_and_rank_counts():
    assert count.dense_flop(3, 4, 5) == 120.0
    ranks = np.array([[2, 0], [1, 3]])
    # ranks 2 and 1 cost 2·r·(8 + 4) a column; rank 3 the dense block's 2·8·4
    assert count.rank_flop(ranks, 8, 4, 10) == (48 + 24 + 64) * 10
    assert count.tiled_bytes(4, 6, 8, 3) == (24 + 48 + 3 * 32) * 4
    peak = {"flops": 10.0, "bytes_per_s": 2.0}
    assert count.least_seconds(100.0, 4.0, peak) == 10.0
    assert count.least_seconds(1.0, 40.0, peak) == 20.0


@pytest.mark.parametrize("seed", [0, 5])
def test_frozen_makers_match_the_program_at_freezing(seed):
    run.use_program()
    from repro_torch.core.blocking import paper_nonuniform_sizes
    from repro_torch.core.sparsity import mask_matmul_flops, random_block_mask

    a = cases.random_block_mask(16, 16, 0.3, np.random.default_rng(seed))
    assert np.array_equal(a, random_block_mask(16, 16, 0.3, seed=seed))
    b = cases.random_block_mask(16, 16, 0.3, np.random.default_rng(seed + 9))
    assert count.blocksparse_flop(a, b, 32) == mask_matmul_flops(a, b, 32, 32, 32)[0]
    assert cases.paper_nonuniform_sizes(4096, 16, np.random.default_rng(seed)) == \
        paper_nonuniform_sizes(4096, 16, np.random.default_rng(seed))


def test_nonuniform_sizes_are_one_multiset_in_seeded_orders():
    one = cases.nonuniform_sizes(8192, 32, 0, seed=1)
    two = cases.nonuniform_sizes(8192, 32, 0, seed=2**40 + 3)
    assert one != two
    for x, y in zip(one, two):
        assert sorted(x) == sorted(y) and sum(x) == 8192 and len(x) == 32
    assert one == cases.nonuniform_sizes(8192, 32, 0, seed=1)


def test_streams_repeat_for_a_seed_and_take_any_whole_number():
    import torch

    for seed in (0, -1, 2**31 + 1, 2**70):
        x = cases.operand(8, seed, cases.A_VALUES, "cpu")
        assert torch.equal(x, cases.operand(8, seed, cases.A_VALUES, "cpu"))
        assert not torch.equal(x, cases.operand(8, seed, cases.B_VALUES, "cpu"))
    b1, b2 = torch.zeros(64, 4), torch.zeros(64, 4)
    s1, s2 = cases.BandStream(64, 16, 9, "cpu"), cases.BandStream(64, 16, 9, "cpu")
    for _ in range(5):
        assert s1.redraw(b1) == s2.redraw(b2)
    assert torch.equal(b1, b2)
