"""The rank-sparse route: ``DistributedMatmul(None, b, a_ranks=RankCSR)``.

The port against the reference, with the same numpy factors and B handed
to both packages: the grouped-GEMM wrapper and the single-launch local
route against the reference's kernels in interpret mode (tolerances of
``tests/test_kernels.py`` and ``tests/conftest.py``), the 1x1 slice on both
local routes against the reference's ``DistributedMatmul``, plan parity for
``RankCSR`` plans, pull against broadcast bitwise, and a 2x2 grid of gloo
processes against the float64 densified oracle.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ORACLE_ATOL, ORACLE_RTOL, SRC
from repro.core import DistributedMatmul as RefDistributedMatmul
from repro.core import sparsity as ref_sp
from repro.core.plan import plan_matmul as ref_plan_matmul
from repro.kernels import ops as ref_ops
from repro.launch.mesh import make_host_mesh
from repro_torch.configs.paper_mm import make_case, make_rank_case
from repro_torch.core import DistributedMatmul, Grid
from repro_torch.core import plan_matmul as port_plan_matmul
from repro_torch.core import summa as sm
from repro_torch.core.sparsity import (
    BlockRankMap,
    block_norms,
    decay_rank_map,
    random_block_mask,
    synthesize_rank_csr,
)
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_gemm import (
    grouped_gemm_cuda,
    grouped_gemm_plain,
    tile_pairs,
)
from test_torch_plan import FakeMesh, assert_plans_equal

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(name):
    return 2e-2 if name == "bfloat16" else 1e-4


def _rank_pair(m_blocks, k_blocks, bm, bk, *, max_rank, decay, seed,
               threshold=1e-2):
    """The same ``RankCSR`` from each package's own generators."""
    kw = dict(max_rank=max_rank, decay=decay, threshold=threshold)
    port = synthesize_rank_csr(
        decay_rank_map(m_blocks, k_blocks, bm, bk, **kw), seed=seed)
    ref = ref_sp.synthesize_rank_csr(
        ref_sp.decay_rank_map(m_blocks, k_blocks, bm, bk, **kw), seed=seed)
    return port, ref


class _Spy:
    """Counts the calls of a plain version the wrappers route to."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def spies(monkeypatch):
    out = {"tiled": _Spy(ops.tiled_matmul_plain),
           "grouped": _Spy(ops.grouped_gemm_plain)}
    monkeypatch.setattr(ops, "tiled_matmul_plain", out["tiled"])
    monkeypatch.setattr(ops, "grouped_gemm_plain", out["grouped"])
    return out


# ---------------------------------------------------------------------------
# carry-across and kernels
# ---------------------------------------------------------------------------


def test_make_rank_case_carries_across():
    rcsr, b = make_rank_case(512, 32, 8, seed=3)
    ref = ref_sp.synthesize_rank_csr(
        ref_sp.decay_rank_map(16, 16, 32, 32, max_rank=8, decay=0.5,
                              threshold=1e-2), seed=3)
    for f in ("u", "v", "ranks"):
        np.testing.assert_array_equal(getattr(rcsr, f), getattr(ref, f))
    np.testing.assert_array_equal(rcsr.csr.col_idx, ref.csr.col_idx)
    np.testing.assert_array_equal(rcsr.csr.row_ptr, ref.csr.row_ptr)
    assert rcsr.r_pad == 8 and b.shape == (512, 512) and b.dtype == np.float32
    # B is make_case's A of the same seed, so a caller can reuse it
    np.testing.assert_array_equal(b, make_case(512, 32, 1.0, seed=3)[0])


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize(
    "t,d,f,e,bt",
    [(256, 64, 96, 4, 64), (512, 128, 64, 8, 128), (64, 32, 40, 3, 8)],
)
def test_grouped_gemm_matches_reference(t, d, f, e, bt, name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(t + bt)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    te = rng.integers(0, e, size=t // bt).astype(np.int32)
    want = ref_ops.grouped_gemm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(te), bt=bt, bk=32, bn=32)
    before = grouped_gemm_cuda.launches
    got = ops.grouped_gemm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(w).to(tdt), te, bt=bt)
    assert grouped_gemm_cuda.launches == before  # the CPU runs no kernel
    assert got.shape == (t, f) and got.dtype == tdt
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=_tol(name), atol=_tol(name) * d ** 0.5,
    )


def _split_bf16(x: torch.Tensor):
    """hi = bf16(x), lo = bf16(x - hi), as fp32 (csrc/split_gemm.cuh)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize(
    "t,d,f,e,bt",
    [(128, 256, 256, 2, 64), (256, 64, 96, 4, 64), (512, 128, 64, 8, 128),
     (64, 32, 40, 3, 8)],
)
def test_split_bf16_product_holds_the_fp32_tolerance(t, d, f, e, bt):
    """The CUDA kernel's arithmetic for fp32 operands, emulated: each
    operand split into bf16 hi and lo, three products hi·hi + hi·lo +
    lo·hi summed in fp32 (a bf16 product is exact in fp32), against the
    reference's fp32 grouped GEMM at its fp32 tolerance (rtol 1e-4, atol
    1e-4·√D) — at the main path's D = 256 and the reference's shapes."""
    rng = np.random.default_rng(t + d)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    te = rng.integers(0, e, size=t // bt).astype(np.int32)
    want = np.asarray(ref_ops.grouped_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(te), bt=bt, bk=32,
        bn=32), np.float32)
    x_hi, x_lo = _split_bf16(torch.from_numpy(x))
    w_hi, w_lo = _split_bf16(torch.from_numpy(w))
    xt = [part.view(t // bt, bt, d) for part in (x_hi, x_lo)]
    we = [part[torch.from_numpy(te).long()] for part in (w_hi, w_lo)]
    got = (torch.bmm(xt[0], we[0]) + torch.bmm(xt[0], we[1])
           + torch.bmm(xt[1], we[0])).reshape(t, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * d ** 0.5)
    # one bf16 product does not hold it: the split is what carries fp32
    one = torch.bmm(xt[0], we[0]).reshape(t, f).numpy()
    assert not np.allclose(one, want, rtol=1e-4, atol=1e-4 * d ** 0.5)


@pytest.mark.parametrize(
    "te,bt",
    [([3, 0, 0, 2, 1, 3, 2, 1], 8), ([1, 0, 1], 128), ([0, 1, 0, 1, 0], 64),
     (list(np.tile(np.arange(128), 8)), 64), ([2, 2, 2], 100), ([], 64)],
)
def test_tile_pairs_cover_every_unit_once(te, bt):
    """The kernel's work list: every 64-row unit of every tile once, two
    units of one expert a pair (or one, the second -1), pairs ordered by
    expert; on the main path's map (8 tiles for each of 128 experts) every
    unit has a partner."""
    te = np.asarray(te, np.int32)
    pairs = tile_pairs(te, bt)
    assert pairs.dtype == np.int32 and pairs.shape[1:] == (2,)
    units = [tile * bt + sub for tile in range(te.size)
             for sub in range(0, bt, 64)]
    listed = pairs[pairs >= 0]
    assert sorted(listed.tolist()) == units
    experts = te[pairs[:, 0] // bt]
    assert np.all(np.diff(experts) >= 0)
    second = pairs[:, 1] >= 0
    assert np.all(te[pairs[second, 1] // bt] == experts[second])
    per_expert = np.bincount(te, minlength=int(te.max(initial=0)) + 1)
    units_per_expert = per_expert * -(-bt // 64)
    assert (~second).sum() == (units_per_expert % 2).sum()
    if te.size == 1024:
        assert second.all() and pairs.shape[0] == 512


def test_grouped_gemm_wrapper_checks_its_map():
    x, w = torch.ones(16, 4), torch.ones(2, 4, 3)
    with pytest.raises(ValueError, match="expert"):
        ops.grouped_gemm(x, w, np.array([0, 2]), bt=8)
    with pytest.raises(ValueError, match="divide"):
        ops.grouped_gemm(x, w, np.array([0]), bt=12)
    with pytest.raises(ValueError, match="one entry per"):
        grouped_gemm_plain(x, w, torch.zeros(3, dtype=torch.int32), bt=8)
    y = ops.grouped_gemm(x.to("meta"), w.to("meta"), np.array([0, 1]), bt=8)
    assert y.device.type == "meta" and y.shape == (16, 3)  # shape-only
    with pytest.raises(ValueError, match="CUDA"):
        grouped_gemm_cuda(x, w, torch.zeros(2, dtype=torch.int32), bt=8)


@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
def test_ranksparse_matmul_matches_reference(b_dtype):
    """The single-launch local route on the oracle's case (r_pad = 8)."""
    jdt, tdt = DTYPES[b_dtype]
    port, ref = _rank_pair(4, 4, 32, 32, max_rank=8, decay=0.8, seed=5)
    assert port.r_pad == 8
    b = np.random.default_rng(5).normal(size=(128, 96)).astype(np.float32)
    want = np.asarray(ref_ops.ranksparse_matmul(ref, jnp.asarray(b, jdt)),
                      np.float32)
    got = ops.ranksparse_matmul(port, torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and got.shape == (128, 96)
    tol = ORACLE_ATOL if b_dtype == "float32" else _tol(b_dtype) * 128 ** 0.5
    rtol = ORACLE_RTOL if b_dtype == "float32" else _tol(b_dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=rtol)


# ---------------------------------------------------------------------------
# the 1x1 slice against the reference's DistributedMatmul
# ---------------------------------------------------------------------------


def _rank_case(name):
    """(port RankCSR, ref RankCSR, b, call kwargs by package, r* side)."""
    rng = np.random.default_rng(11)
    if name == "densified":  # r_pad 24 > r* = 16: every grouped panel dense
        port, ref = _rank_pair(4, 4, 32, 32, max_rank=24, decay=0.3, seed=2)
    elif name == "ragged":  # 40-row blocks, N = 90: ragged 64-row/col tiles
        port, ref = _rank_pair(3, 4, 40, 32, max_rank=8, decay=0.6, seed=4)
    else:
        port, ref = _rank_pair(4, 4, 32, 32, max_rank=8, decay=0.8, seed=5)
    m, k = port.shape
    n = 90 if name == "ragged" else 96
    b = rng.normal(size=(k, n)).astype(np.float32)
    kw = {}
    if name == "masks_filter":
        b_mask = random_block_mask(4, 3, 0.7, seed=6)
        c_mask = np.ones((4, 3), bool)
        c_mask[1, 2] = c_mask[3, 0] = False
        kw = dict(b_mask=b_mask, c_mask=c_mask,
                  b_norms=block_norms(b, 4, 3, mask=b_mask), filter_eps=0.3)
    return port, ref, b, kw


RANK_CASES = ["factored", "densified", "masks_filter", "ragged", "bf16_b"]


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_route_matches_reference_1x1(case, local_matmul, spies):
    port_rk, ref_rk, b, kw = _rank_case(case)
    jdt, tdt = DTYPES["bfloat16" if case == "bf16_b" else "float32"]
    mm = DistributedMatmul(Grid.local("cpu"), strategy="taskbased",
                           local_matmul=local_matmul)
    ref = RefDistributedMatmul(make_host_mesh(1, 1), strategy="taskbased",
                               local_matmul=local_matmul)
    got = mm(None, torch.from_numpy(b).to(tdt), a_ranks=port_rk, **kw)
    want = np.asarray(ref(None, jnp.asarray(b, jdt), a_ranks=ref_rk, **kw),
                      np.float32)
    assert got.dtype == tdt and got.shape == want.shape
    assert got.device.type == "cpu"
    if case == "bf16_b":  # both promote to fp32, then round C to bf16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL,
                                   rtol=ORACLE_RTOL)
    (plan,) = mm._plan_cache.values()
    assert plan.local_impl == "ranksparse"
    if case == "ragged":
        assert plan.padded_shapes == ((120, 128), (128, 90))
    if local_matmul == "pallas":
        dense = case == "densified"
        assert (spies["grouped"].calls == 0) == dense
        assert (spies["tiled"].calls > 0) == dense
    else:
        assert spies["grouped"].calls == 0
    if case == "masks_filter":
        assert np.all(got.numpy()[32:64, 64:96] == 0)


def test_rank_route_chunks_by_block_rows(monkeypatch, spies):
    """A small chunk budget splits both factored stages into chunks of
    block rows; the result stays within the fp32 tolerance of one chunk."""
    port, _ = _rank_pair(8, 4, 16, 32, max_rank=8, decay=0.8, seed=9)
    b = torch.from_numpy(
        np.random.default_rng(9).normal(size=(128, 64)).astype(np.float32))
    want = {}
    for lm in ("xla", "pallas"):
        want[lm] = DistributedMatmul(Grid.local("cpu"), local_matmul=lm)(
            None, b, a_ranks=port)
    calls = spies["grouped"].calls
    assert calls == 1
    # one block row's stage-1 output: 4 panels x r_pad 8 x 64 x 4 bytes
    monkeypatch.setattr(sm, "RANK_CHUNK_BYTES", 3 * 4 * 8 * 64 * 4)
    for lm in ("xla", "pallas"):
        got = DistributedMatmul(Grid.local("cpu"), local_matmul=lm)(
            None, b, a_ranks=port)
        np.testing.assert_allclose(got.numpy(), want[lm].numpy(),
                                   atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    assert spies["grouped"].calls - calls == 3  # ceil(8 / 3) chunks


def test_pull_equals_broadcast_bitwise_1x1():
    port, _ = _rank_pair(4, 4, 32, 32, max_rank=12, decay=0.4, seed=13)
    rng = np.random.default_rng(13)
    b = rng.normal(size=(128, 96)).astype(np.float32)
    kw = dict(b_mask=random_block_mask(4, 3, 0.7, seed=13),
              c_mask=np.eye(4, 3, dtype=bool) | np.eye(4, 3, 1, dtype=bool))
    for lm in ("xla", "pallas"):
        mm = DistributedMatmul(Grid.local("cpu"), local_matmul=lm)
        pull = mm(None, b, a_ranks=port, comm_mode="pull", **kw)
        bcast = DistributedMatmul(Grid.local("cpu"), local_matmul="xla")(
            None, b, a_ranks=port, **kw)
        assert torch.equal(pull, bcast), lm
        assert mm.plan(128, 128, 96, a_ranks=port, comm_mode="pull",
                       **kw).local_impl == "ranksparse"


def test_rank_call_errors_and_densify_fallback():
    port, ref_rcsr = _rank_pair(4, 4, 8, 8, max_rank=4, decay=0.8, seed=1)
    b = np.ones((32, 16), np.float32)
    mm = DistributedMatmul(Grid.local("cpu"))
    with pytest.raises(ValueError, match="a=None"):
        mm(port.to_dense(), b, a_ranks=port)
    with pytest.raises(ValueError, match="requires a_ranks"):
        mm(None, b)
    with pytest.raises(ValueError, match="not both"):
        mm(None, b, a_ranks=port, a_mask=np.ones((4, 4), bool))
    with pytest.raises(ValueError, match="contraction"):
        mm(None, np.ones((24, 16), np.float32), a_ranks=port)
    # B-stationary plans cannot carry factors: densified and run on the
    # stationary route (ROADMAP A7), as the reference does
    plan = mm.plan(32, 32, 16, a_ranks=port, stationarity="B")
    assert plan.local_impl == "masked"
    want = RefDistributedMatmul(make_host_mesh(1, 1))(
        None, jnp.asarray(b), a_ranks=ref_rcsr, stationarity="B")
    np.testing.assert_allclose(
        mm(None, b, a_ranks=port, stationarity="B").numpy(),
        np.asarray(want), atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    with pytest.raises(ValueError, match="not a rank-sparse plan"):
        sm.execute_rank_plan(torch.ones(32, 16), torch.ones(16, 32),
                             torch.ones(32, 16), plan)
    rank_plan = mm.plan(32, 32, 16, a_ranks=port)
    with pytest.raises(ValueError, match="factor tiles"):
        sm.execute_rank_plan(torch.ones(32, 16), torch.ones(8, 32),
                             torch.ones(32, 16), rank_plan)
    # the oracle densifies and applies B's mask
    b_mask = np.eye(4, 2, dtype=bool)
    want = port.to_dense() @ (b * np.kron(b_mask, np.ones((8, 8))))
    got = sm.reference_ranksparse_matmul(port, torch.from_numpy(b), b_mask)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# plan parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm_mode", ["broadcast", "pull"])
@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_rank_csr_plan_matches_reference(grid, local_matmul, comm_mode):
    port_rk, ref_rk = _rank_pair(8, 8, 16, 16, max_rank=6, decay=0.6, seed=3)
    b_mask = random_block_mask(8, 4, 0.7, seed=4)
    port_mm = DistributedMatmul(Grid(sizes=grid, device="cpu"), k_blocks=8,
                                local_matmul=local_matmul)
    ref_mm = RefDistributedMatmul(
        FakeMesh({"data": grid[0], "model": grid[1]}), k_blocks=8,
        local_matmul=local_matmul)
    kw = dict(b_mask=b_mask, comm_mode=comm_mode)
    port = port_mm.plan(128, 128, 96, a_ranks=port_rk, **kw)
    ref = ref_mm.plan(128, 128, 96, a_ranks=ref_rk, **kw)
    assert_plans_equal(port, ref)
    assert port.local_impl == "ranksparse"
    # the same structure as a bare rank map: another key, another plan
    rank_map = port_rk.rank_map()
    port_map = port_mm.plan(128, 128, 96, a_ranks=rank_map, **kw)
    ref_map = ref_mm.plan(128, 128, 96, a_ranks=ref_rk.rank_map(), **kw)
    assert port_map is not port and port_map.local_impl != "ranksparse"
    assert_plans_equal(port_map, ref_map)
    assert port_mm.cache_stats()["plan"]["size"] == 2
    # same structure, other factors: the cached rank plan
    other = synthesize_rank_csr(rank_map, seed=99)
    assert port_mm.plan(128, 128, 96, a_ranks=other, **kw) is port
    assert port_mm.plan(128, 128, 96, a_ranks=BlockRankMap(
        ranks=rank_map.ranks.copy(), bm=16, bk=16), **kw) is port_map


def test_commodity_rank_plan_matches_reference():
    """The chip smoke test's rank plan, at the paper's commodity size."""
    n, block = 32_768, 256
    rank_map = decay_rank_map(128, 128, block, block, max_rank=64,
                              decay=0.5, threshold=1e-2)
    ref_map = ref_sp.decay_rank_map(128, 128, block, block, max_rank=64,
                                    decay=0.5, threshold=1e-2)
    np.testing.assert_array_equal(rank_map.ranks, ref_map.ranks)
    port_cfg = DistributedMatmul(Grid(sizes=(1, 1)), k_blocks=128,
                                 local_matmul="pallas").config()
    ref_cfg = RefDistributedMatmul(make_host_mesh(1, 1), k_blocks=128,
                                   local_matmul="pallas").config()
    p = port_plan_matmul(n, n, n, port_cfg, a_ranks=rank_map)
    r = ref_plan_matmul(n, n, n, ref_cfg, a_ranks=ref_map)
    assert_plans_equal(p, r)
    assert p.local_impl == "ranksparse" and len(p.live_panels) == 128
    assert int((rank_map.ranks > 0).sum()) == 2342
    assert p.cost.flops_sparse == 1133535821824.0


# ---------------------------------------------------------------------------
# 2x2 grid of gloo processes
# ---------------------------------------------------------------------------

_RANK_PROGRAM = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import DistributedMatmul, Grid
from repro_torch.core import plan_matmul as port_plan_matmul
from repro_torch.core.sparsity import decay_rank_map, synthesize_rank_csr

rank, rdv, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
torch.set_num_threads(1)
case = np.load(data)
grid = Grid.from_process_group(*case["grid"].tolist(), device="cpu")
mb, kb, bm, bk, max_rank = case["rank_map"].tolist()
rcsr = synthesize_rank_csr(decay_rank_map(
    mb, kb, bm, bk, max_rank=max_rank, decay=0.4), seed=13)
kw = {name: case[name] for name in ("b_mask", "c_mask") if name in case.files}
n = case["b"].shape[1]
out = {}
for key in case["routes"].tolist():
    route, mode = key.split("-")
    mm = DistributedMatmul(grid, strategy="taskbased", k_blocks=kb,
                           local_matmul=route)
    plan = mm.plan(mb * bm, kb * bk, n, a_ranks=rcsr, comm_mode=mode, **kw)
    out[key] = mm(None, case["b"], a_ranks=rcsr, comm_mode=mode,
                  **kw).numpy()
    out[f"{key}-impl"] = np.array(plan.local_impl)
    out["padded"] = np.array(plan.padded_shapes)
if rank == 0:
    np.savez(data.replace("case", "out"), dense=rcsr.to_dense(), **out)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("case", ["masked", "ragged", "fallback"])
def test_gloo_grid_rank_route_matches_oracle(tmp_path, case):
    """Four gloo processes, on both local routes and the pull route, held
    against the float64 densified product.  On the 2x2 grid U/V panels are
    broadcast along grid rows and B panels along grid columns:
    ``masked`` has B's mask and an output filter, max rank 4; ``ragged``
    has N = 33, padded to 34 for the two grid columns, and max rank 12,
    which sends the panels of rank above r* = 8 through the dense-panel
    fallbacks.  ``fallback`` is a 4x1 grid whose 4 rows do not divide the
    6 block rows: the factors are densified into the masked DAG."""
    rng = np.random.default_rng(13)
    grid, rank_map = (2, 2), (8, 8, 16, 16, 4 if case == "masked" else 12)
    if case == "fallback":
        grid, rank_map = (4, 1), (6, 4, 2, 8, 2)
    m, k = rank_map[0] * rank_map[2], rank_map[1] * rank_map[3]
    n = {"masked": 96, "ragged": 33, "fallback": 16}[case]
    b = rng.normal(size=(k, n)).astype(np.float32)
    b_keep, c_keep = np.ones((k, n)), np.ones((m, n))
    masks = {}
    if case == "masked":
        masks["b_mask"] = random_block_mask(8, 4, 0.7, seed=13)
        masks["c_mask"] = np.ones((8, 4), bool)
        masks["c_mask"][2, 1] = masks["c_mask"][5, 3] = False
        b_keep = np.kron(masks["b_mask"], np.ones((16, 24)))
        c_keep = np.kron(masks["c_mask"], np.ones((16, 24)))
    data = tmp_path / "case.npz"
    # the pull route of a densified (mask) plan is not ported (A7)
    routes = ["xla-broadcast", "pallas-broadcast"]
    routes += [] if case == "fallback" else ["xla-pull"]
    np.savez(data, b=b, grid=np.array(grid), rank_map=np.array(rank_map),
             routes=np.array(routes), **masks)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_PROGRAM, str(rank),
             str(tmp_path / "rdv"), str(data)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(4)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    out = np.load(tmp_path / "out.npz")
    want = out["dense"].astype(np.float64) @ (b * b_keep) * c_keep
    if case == "ragged":
        assert out["padded"].tolist() == [[128, 128], [128, 34]]
    impl = "masked" if case == "fallback" else "ranksparse"
    for key in routes:
        np.testing.assert_allclose(out[key], want, atol=ORACLE_ATOL,
                                   rtol=ORACLE_RTOL, err_msg=key)
        assert str(out[f"{key}-impl"]) == impl
    if "xla-pull" in routes:
        np.testing.assert_array_equal(out["xla-pull"], out["xla-broadcast"])
