"""Plan parity: the port's ``plan_matmul`` against the reference's.

Every ``MatmulPlan`` field must equal the reference's for the same inputs
(the planner is numpy in both packages); only ``digest()`` differs, since
it hashes the grid where the reference hashes mesh devices — it is held to
stability and sensitivity instead.  The reference plans over a
``FakeMesh`` (as ``tests/test_filter_props.py`` does), the port over a
planning-only ``Grid``.
"""
import re

import numpy as np
import pytest
import torch

from repro.core import sparsity as ref_sp
from repro.core.plan import plan_matmul as ref_plan_matmul
from repro.core.summa import SummaConfig as RefSummaConfig
from repro.spgemm import output_mask
from repro_torch.core import Grid, SummaConfig, plan_matmul
from repro_torch.core.sparsity import BlockRankMap

M, K, N, BLOCKS = 64, 128, 96, 8
GRIDS = [(1, 1), (2, 2), (2, 4)]
FAMILIES = ["dense", "random", "banded", "decay", "one_sided", "rank"]
VARIANTS = ["plain", "c_mask", "filter", "auto"]


class FakeMesh:
    def __init__(self, sizes):
        self.shape = sizes


def _cfgs(p_row, p_col, **kw):
    ref = RefSummaConfig(
        mesh=FakeMesh({"data": p_row, "model": p_col}), **kw
    )
    port = SummaConfig(grid=Grid(sizes=(p_row, p_col)), **kw)
    return port, ref


def _structure(family):
    """(a_mask, b_mask, a_rank_grid) of one structure family."""
    a_mask = b_mask = ranks = None
    if family == "random":
        a_mask = ref_sp.random_block_mask(BLOCKS, BLOCKS, 0.5, seed=1)
        b_mask = ref_sp.random_block_mask(BLOCKS, BLOCKS, 0.6, seed=2)
    elif family == "banded":
        a_mask = ref_sp.banded_block_mask(BLOCKS, BLOCKS, 1)
        b_mask = ref_sp.banded_block_mask(BLOCKS, BLOCKS, 2)
    elif family == "decay":
        a_mask = ref_sp.decay_block_mask(BLOCKS, BLOCKS, 0.8, 5e-2)
        b_mask = ref_sp.decay_block_mask(BLOCKS, BLOCKS, 0.5, 5e-2)
    elif family == "one_sided":
        b_mask = ref_sp.banded_block_mask(BLOCKS, BLOCKS, 2)
    elif family == "rank":
        ranks = ref_sp.decay_rank_map(
            BLOCKS, BLOCKS, M // BLOCKS, K // BLOCKS, max_rank=4, decay=0.7,
            threshold=2e-2,
        ).ranks
        b_mask = ref_sp.random_block_mask(BLOCKS, BLOCKS, 0.6, seed=3)
    return a_mask, b_mask, ranks


def _plan_kwargs(family, variant, *, rank_cls):
    a_mask, b_mask, ranks = _structure(family)
    kw = dict(a_mask=a_mask, b_mask=b_mask)
    if ranks is not None:
        kw = dict(
            a_ranks=rank_cls(ranks=ranks, bm=M // BLOCKS, bk=K // BLOCKS),
            b_mask=b_mask,
        )
    if variant == "c_mask":
        a_struct = a_mask if ranks is None else ranks > 0
        c = output_mask(a_struct, b_mask, m_blocks=BLOCKS, n_blocks=BLOCKS)
        if c is not None:
            c = c.copy()
            c[::3] = False  # narrower than the symbolic product
        kw["c_mask"] = c
    elif variant == "filter":
        rng = np.random.default_rng(5)
        a_live = np.ones((BLOCKS, BLOCKS), bool) if a_mask is None else a_mask
        b_live = np.ones((BLOCKS, BLOCKS), bool) if b_mask is None else b_mask
        if ranks is not None:
            a_live = ranks > 0
        kw["a_norms"] = rng.uniform(0.0, 1.0, (BLOCKS, BLOCKS)) * a_live
        kw["b_norms"] = rng.uniform(0.0, 1.0, (BLOCKS, BLOCKS)) * b_live
        kw["filter_eps"] = 0.15
    elif variant == "auto":
        kw["stationarity"] = "auto"
    return kw


def _arr_eq(x, y):
    if x is None or y is None:
        assert x is None and y is None
    else:
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype


def assert_plans_equal(port, ref):
    for f in ("m", "k", "n", "m_pad", "k_pad", "n_pad", "k_steps",
              "kb_width", "live_panels", "local_block", "local_impl",
              "itemsize", "lookahead", "comm_mode", "stationarity",
              "filter_eps", "filter_bound", "padded_shapes",
              "skipped_panels_global"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("a_mask", "b_mask", "device_live", "local_cols", "a_ranks",
              "b_ranks", "c_mask", "c_norms"):
        _arr_eq(getattr(port, f), getattr(ref, f))
    _arr_eq(port.skipped_panels_per_device(), ref.skipped_panels_per_device())
    assert port.resolve_lookahead() == ref.resolve_lookahead()
    for f in ("flops_dense", "flops_sparse", "fill_in", "flops_mask"):
        assert getattr(port.cost, f) == getattr(ref.cost, f), f
    assert port.cost.comm_bytes == ref.cost.comm_bytes
    port_s, ref_s = port.summary(), ref.summary()
    assert port_s == ref_s


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_plan_fields_match_reference(grid, family, local_matmul, variant):
    port_cfg, ref_cfg = _cfgs(*grid, local_matmul=local_matmul)
    port_kw = _plan_kwargs(family, variant, rank_cls=BlockRankMap)
    ref_kw = _plan_kwargs(family, variant, rank_cls=ref_sp.BlockRankMap)
    try:
        ref = ref_plan_matmul(M, K, N, ref_cfg, **ref_kw)
    except ValueError as e:  # e.g. c_mask on a dense product
        with pytest.raises(ValueError, match=re.escape(str(e)[:30])):
            plan_matmul(M, K, N, port_cfg, **port_kw)
        return
    port = plan_matmul(M, K, N, port_cfg, **port_kw)
    assert_plans_equal(port, ref)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("k_blocks", [None, 8, 16])
@pytest.mark.parametrize("strategy", ["procedural", "taskbased", "allgather"])
def test_dense_plan_schedule_matches_reference(grid, k_blocks, strategy):
    port_cfg, ref_cfg = _cfgs(*grid, k_blocks=k_blocks, strategy=strategy)
    for m, k, n in ((64, 128, 96), (50, 70, 33)):
        try:
            ref = ref_plan_matmul(m, k, n, ref_cfg, itemsize=2)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e)[:30])):
                plan_matmul(m, k, n, port_cfg, itemsize=2)
            continue
        assert_plans_equal(plan_matmul(m, k, n, port_cfg, itemsize=2), ref)


def test_commodity_plans_match_reference():
    """The chip smoke test's two plans, at the paper's commodity size."""
    from repro_torch.configs.paper_mm import make_case

    n, block = 32_768, 256
    nb = n // block
    a_mask = ref_sp.random_block_mask(nb, nb, 0.3, seed=1)
    b_mask = ref_sp.random_block_mask(nb, nb, 0.3, seed=2)
    port_cfg, ref_cfg = _cfgs(1, 1, k_blocks=128, local_matmul="pallas")
    dense = plan_matmul(n, n, n, port_cfg)
    assert_plans_equal(dense, ref_plan_matmul(n, n, n, ref_cfg))
    assert dense.k_steps == 128 and dense.kb_width == 256
    sparse = plan_matmul(n, n, n, port_cfg, a_mask=a_mask, b_mask=b_mask)
    assert_plans_equal(
        sparse, ref_plan_matmul(n, n, n, ref_cfg, a_mask=a_mask, b_mask=b_mask)
    )
    assert sparse.local_impl == "bsmm"
    assert sparse.local_block == (256, 256, 256)
    # make_case's masks are the ones planned above
    _, _, am, bm = make_case(512, 4, 0.3, seed=0)  # tiny operands, same grid
    np.testing.assert_array_equal(am, a_mask)
    np.testing.assert_array_equal(bm, b_mask)


def test_digest_is_stable_and_sensitive():
    cfg, _ = _cfgs(2, 2, local_matmul="pallas")
    a_mask, b_mask, _ = _structure("random")
    p1 = plan_matmul(M, K, N, cfg, a_mask=a_mask, b_mask=b_mask)
    p2 = plan_matmul(M, K, N, cfg, a_mask=a_mask.copy(), b_mask=b_mask.copy())
    assert p1.digest() == p2.digest()
    assert len(p1.digest()) == 40
    other_mask = a_mask.copy()
    other_mask[0, 0] = not other_mask[0, 0]
    other_grid, _ = _cfgs(2, 4, local_matmul="pallas")
    variants = [
        plan_matmul(M, K, N, cfg, a_mask=other_mask, b_mask=b_mask),
        plan_matmul(M, K, N, other_grid, a_mask=a_mask, b_mask=b_mask),
        plan_matmul(
            M, K, N, _cfgs(2, 2, local_matmul="xla")[0],
            a_mask=a_mask, b_mask=b_mask,
        ),
        plan_matmul(M, K, N, cfg, a_mask=a_mask, b_mask=b_mask, itemsize=2),
        plan_matmul(
            M, K, N, SummaConfig(grid=Grid(sizes=(2, 2)), local_matmul="pallas",
                                 accum_dtype=torch.bfloat16),
            a_mask=a_mask, b_mask=b_mask,
        ),
        plan_matmul(M, K, N, cfg),
    ]
    digests = {p.digest() for p in variants}
    assert p1.digest() not in digests and len(digests) == len(variants)
    # the grid's device is part of the fingerprint
    on_meta = SummaConfig(
        grid=Grid(sizes=(2, 2), device=torch.device("meta")),
        local_matmul="pallas",
    )
    assert plan_matmul(
        M, K, N, on_meta, a_mask=a_mask, b_mask=b_mask
    ).digest() != p1.digest()


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_eps_zero_norms_keep_the_digest(grid):
    """Norms with ``filter_eps=0`` are a bitwise no-op on the plan, on the
    valid grids of the reference's property test."""
    cfg, _ = _cfgs(*grid, k_blocks=BLOCKS)
    rng = np.random.default_rng(0)
    a_mask, b_mask, _ = _structure("random")
    norms = rng.uniform(0.5, 2.0, (BLOCKS, BLOCKS))
    base = plan_matmul(M, K, N, cfg, a_mask=a_mask, b_mask=b_mask)
    p0 = plan_matmul(M, K, N, cfg, a_mask=a_mask, b_mask=b_mask,
                     a_norms=norms, b_norms=norms, filter_eps=0.0)
    assert p0.digest() == base.digest() and p0.filter_bound == 0.0
    dense = plan_matmul(M, K, N, cfg)
    d0 = plan_matmul(M, K, N, cfg, a_norms=norms, b_norms=norms,
                     filter_eps=0.0)
    assert d0.digest() == dense.digest()
