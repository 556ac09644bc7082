"""Nonuniform blocking: the port's ``core.blocking`` and
``NonuniformMatmul`` against the reference's.

The blocking helpers are numpy in both packages and must agree exactly:
the same sizes for the same seed, the same bucketization (``block_id``,
``valid``, ``gather_indices``, ``padding_waste``) and the same load
statistics.  ``NonuniformMatmul`` runs on the 1x1 grid in both packages
with the same numpy operands and is held at the distributed products'
tolerances (``ORACLE_ATOL``, rtol 1e-4), with and without a logical rank
map, and with ``tile="auto"`` on a cold and a warm autotune cache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.blocking as ref_bk
from conftest import ORACLE_ATOL
from repro.core.api import DistributedMatmul as RefDistributedMatmul
from repro.core.api import NonuniformMatmul as RefNonuniformMatmul
from repro.kernels import autotune as ref_at
from repro.launch.mesh import make_host_mesh
from repro_torch.configs.paper_mm import (
    BENCH_CONFIGS,
    COMMODITY_BLOCK,
    COMMODITY_N,
    make_case,
    make_nonuniform_case,
)
from repro_torch.core import DistributedMatmul, Grid, NonuniformMatmul
from repro_torch.core import blocking as bk
from repro_torch.kernels import autotune as at

TILINGS = [(300, 3, 1), (280, 3, 2), (260, 3, 3)]  # (extent, blocks, seed)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def clean_autotune():
    at.set_autotune_cache(None)
    ref_at.set_autotune_cache(None)
    yield
    at.set_autotune_cache(None)
    ref_at.set_autotune_cache(None)


@pytest.mark.parametrize("extent,blocks,seed", [
    (64, 4, 7), (2048, 64, 1), (32768, 128, 0), (32768, 128, 2), (1000, 1, 5),
])
def test_tilings_match_reference(extent, blocks, seed):
    port = bk.nonuniform_tiling(extent, blocks, seed=seed)
    ref = ref_bk.nonuniform_tiling(extent, blocks, seed=seed)
    assert port.sizes == ref.sizes and port.offsets == ref.offsets
    assert port.extent == extent and port.is_uniform == ref.is_uniform
    for i in (0, extent // 3, extent - 1):
        assert port.block_of(i) == ref.block_of(i)
    for block in (7, 256):
        assert (bk.uniform_tiling(extent, block).sizes
                == ref_bk.uniform_tiling(extent, block).sizes)
    assert bk.cyclic_owner(np.arange(9), 4).tolist() == (
        ref_bk.cyclic_owner(np.arange(9), 4).tolist())
    with pytest.raises(ValueError):
        bk.Tiling(())
    with pytest.raises(IndexError):
        port.block_of(extent)


@pytest.mark.parametrize("tile", [32, 128, 256])
@pytest.mark.parametrize("extent,blocks,seed", [
    (300, 3, 1), (2048, 16, 4), (4096, 16, 1), (32768, 128, 1),
])
def test_bucketize_matches_reference(extent, blocks, seed, tile):
    port = bk.bucketize(bk.nonuniform_tiling(extent, blocks, seed=seed), tile)
    ref = ref_bk.bucketize(ref_bk.nonuniform_tiling(extent, blocks,
                                                    seed=seed), tile)
    assert port.block_id == ref.block_id and port.valid == ref.valid
    assert port.padded_extent == ref.padded_extent
    assert port.padding_waste == ref.padding_waste
    np.testing.assert_array_equal(port.gather_indices(), ref.gather_indices())


def test_commodity_padding_matches_reference():
    """The chip's nonuniform case: extents and padding at tiles 256 / 128,
    and ``make_nonuniform_case``'s tilings and operands (at a small n)."""
    tilings = [bk.nonuniform_tiling(COMMODITY_N, COMMODITY_N // COMMODITY_BLOCK,
                                    seed=s) for s in range(3)]
    for tiling, s in zip(tilings, range(3)):
        assert tiling.sizes == ref_bk.nonuniform_tiling(
            COMMODITY_N, COMMODITY_N // COMMODITY_BLOCK, seed=s).sizes
    want = {256: (47872, 47360, 47616), 128: (40320, 40064, 40192)}
    for tile, extents in want.items():
        got = [bk.bucketize(t, tile) for t in tilings]
        assert tuple(x.padded_extent for x in got) == extents
    assert 47360 % 185 == 0 and 47360 // 185 == 256  # k_blocks=185 panels
    small, a, b = make_nonuniform_case(2048, 256, seed=3)
    assert [t.sizes for t in small] == [
        ref_bk.nonuniform_tiling(2048, 8, seed=3 + s).sizes for s in range(3)]
    a2, b2, _, _ = make_case(2048, 256, 1.0, seed=3)
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    assert BENCH_CONFIGS["nonuniform_medium"].num_blocks == 16
    with pytest.raises(ValueError, match="multiple"):
        make_nonuniform_case(1000, 256)


@pytest.mark.parametrize("grid", [None, (2, 2), (4, 4)])
def test_load_stats_match_reference(grid):
    t = [bk.nonuniform_tiling(4096, 32, seed=s) for s in range(3)]
    r = [ref_bk.nonuniform_tiling(4096, 32, seed=s) for s in range(3)]
    for port, ref in (
        (bk.load_stats(t[0], t[2], t[1], grid=grid),
         ref_bk.load_stats(r[0], r[2], r[1], grid=grid)),
        (bk.load_stats(t[0], t[2], grid=grid),
         ref_bk.load_stats(r[0], r[2], grid=grid)),
    ):
        assert (port.memory_min_max, port.work_min_max) == (
            ref.memory_min_max, ref.work_min_max)
        assert port.as_row() == ref.as_row()


def _nonuniform_pair(tile, local_matmul="xla"):
    tilings = [bk.nonuniform_tiling(*t[:2], seed=t[2]) for t in TILINGS]
    ref_tilings = [ref_bk.nonuniform_tiling(*t[:2], seed=t[2])
                   for t in TILINGS]
    port = NonuniformMatmul(
        DistributedMatmul(Grid.local("cpu"), strategy="taskbased",
                          local_matmul=local_matmul),
        *tilings, tile=tile)
    ref = RefNonuniformMatmul(
        RefDistributedMatmul(make_host_mesh(1, 1), strategy="taskbased",
                             local_matmul=local_matmul),
        *ref_tilings, tile=tile)
    return port, ref


@pytest.mark.parametrize("ranked", [False, True], ids=["dense", "rank_map"])
@pytest.mark.parametrize("tile", [128, 256])
def test_nonuniform_matmul_matches_reference(tile, ranked):
    port, ref = _nonuniform_pair(tile)
    assert port.padding_waste == ref.padding_waste
    rng = np.random.default_rng(11)
    a = rng.standard_normal((300, 280), dtype=np.float32)
    b = rng.standard_normal((280, 260), dtype=np.float32)
    kw = {}
    want64 = a.astype(np.float64) @ b
    if ranked:
        ranks = np.array([[4, 0, 2], [0, 3, 0], [1, 0, 5]], np.int32)
        kw["a_ranks"] = ranks
        np.testing.assert_array_equal(
            port.physical_rank_map(ranks).ranks,
            ref.physical_rank_map(ranks).ranks)
        live = np.repeat(np.repeat(ranks > 0, port.row_tiling.sizes, 0),
                         port.inner_tiling.sizes, 1)
        want64 = (a * live).astype(np.float64) @ b
    assert port.plan(**kw).summary() == ref.plan(**kw).summary()
    got = port(a, b, **kw)
    assert got.shape == (300, 260) and got.device.type == "cpu"
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b), **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want64, atol=ORACLE_ATOL,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="mismatches"):
        port(b, b)
    with pytest.raises(ValueError, match="logical rank map"):
        port.physical_rank_map(np.ones((2, 2), np.int32))


def test_nonuniform_matmul_tuned_on_the_kernel_route_matches_reference():
    """``tune=True`` through the tiled kernel's plain version: the tuned
    plans are equal and the products hold."""
    port, ref = _nonuniform_pair(128, local_matmul="pallas")
    assert port.plan(tune=True).tuned == ref.plan(tune=True).tuned
    rng = np.random.default_rng(12)
    a = rng.standard_normal((300, 280), dtype=np.float32)
    b = rng.standard_normal((280, 260), dtype=np.float32)
    got = port(torch.from_numpy(a), torch.from_numpy(b), tune=True)
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b), tune=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL, rtol=1e-4)


def test_nonuniform_auto_tile_matches_reference(clean_autotune):
    """A cold cache gives the static 256 in both; a measured 128-bucket
    winner steers both to 128."""
    port, ref = _nonuniform_pair("auto")
    assert port.tile == ref.tile == 256
    entry = {"winner": "xla", "times_s": {"xla": 1e-7}, "tiles": None}
    port_cache = at.KernelAutotuner(device_kind="cpu")
    ref_cache = ref_at.KernelAutotuner()
    port_cache.table[at.bucket_key(128, 128, 128)] = dict(entry)
    ref_cache.table[ref_at.bucket_key(128, 128, 128)] = dict(entry)
    at.set_autotune_cache(port_cache)
    ref_at.set_autotune_cache(ref_cache)
    port, ref = _nonuniform_pair("auto")
    assert port.tile == ref.tile == 128
    assert at.preferred_tile(300) == ref_at.preferred_tile(300) == 128
    assert at.preferred_tile(100) == ref_at.preferred_tile(100)
