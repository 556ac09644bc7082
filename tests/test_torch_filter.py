"""Norm-filtered (DBCSR-style screened) products against the JAX package.

The reference's ``benchmarks/run.py::bench_filter`` workload at its own
size: n = 1024 in 16 x 16 blocks of 64, fp32, block norms falling as
``exp(-0.8 |i - k|)`` with the band distance, and the threshold sweep
``filter_eps = frac * pmax`` for ``frac`` in (0, 1e-4, 1e-3, 1e-2, 5e-2).
For each ``frac``:

* the port's plan on the abstract 16 x 16 grid equals the reference's
  (every field, ``filter_bound``, the simulated makespan and the gemm-task
  count of ``from_plan``), the count never rises with ``frac`` and the
  filtered schedule is never slower than the unfiltered one;
* the eps-0 plan's digest is bitwise the norm-free plan's (in each
  package: the digests themselves hash the grid, so they differ between
  packages by design, ``tests/test_torch_plan.py``);
* the product through ``DistributedMatmul`` on the 1x1 grid (both local
  routes) is within the reference's kernel tolerance of the reference's
  product (``tests/test_kernels.py::_tol``: 1e-4, the absolute part
  scaled by sqrt(K) as the kernel holds scale it), and its Frobenius
  error against the float64 product within ``filter_bound`` plus the
  reference's slack, 1e-5 x ||C_exact||_F.

The filtered ``contract_chain`` of (A.B).C on three such operands: its
report (plans, bounds, lookaheads, makespans) equal to the reference's,
step 2 planned against the filtered structure of step 1 (its fill never
rises with ``frac`` and falls below the unfiltered chain's), the result
within tolerance of the reference's and within the chain's bound of the
float64 chain: step 1's error ``b1`` reaches the result through C, so
``||(A.B).C - R||_F <= b1 ||C||_F + b2`` (plus the slack).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DistributedMatmul as RefDistributedMatmul
from repro.core import summa as ref_summa
from repro.core.plan import plan_matmul as ref_plan_matmul
from repro.core.sparsity import block_norms as ref_block_norms
from repro.launch.mesh import make_host_mesh
from repro.sched import abstract_summa_config as ref_abstract_config
from repro.sched import from_plan as ref_from_plan
from repro.sched import simulate as ref_simulate
from repro_torch.core import DistributedMatmul, Grid, plan_matmul
from repro_torch.core import summa as port_summa
from repro_torch.core.blocking import Tiling
from repro_torch.core.sparsity import block_norms
from repro_torch.kernels import autotune as at
from repro_torch.sched import abstract_summa_config, from_plan, simulate
from test_torch_plan import assert_plans_equal

ref_contract = importlib.import_module("repro.core.contract")
pc = importlib.import_module("repro_torch.core.contract")

#: bench_filter's size: n = 1024 in BLK x BLK blocks of BS
BLK, N = 16, 1024
BS = N // BLK
DECAY = 0.8
FRACS = (0.0, 1e-4, 1e-3, 1e-2, 5e-2)
#: tests/test_kernels.py::_tol for fp32, and bench_filter's slack
KERNEL_TOL, SLACK = 1e-4, 1e-5
CHAIN_FRACS = (1e-3, 1e-2, 5e-2)


@pytest.fixture(autouse=True)
def _clean_caches():
    """One torch thread; both executable caches and the port's autotune
    cache start empty (bench_filter keeps the autotune cache cold)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    at.set_autotune_cache(None)
    port_summa.clear_executable_cache()
    ref_summa.clear_executable_cache()
    yield
    torch.set_num_threads(prev)
    port_summa.clear_executable_cache()
    ref_summa.clear_executable_cache()


def _operands(count, seed=0):
    """bench_filter's operands: standard normals, each block scaled by
    exp(-0.8 |i - k|), float64 (drawn in its order from one generator)."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-DECAY * np.abs(np.arange(BLK)[:, None]
                                   - np.arange(BLK)[None, :]))
    return [(rng.standard_normal((N, N)).reshape(BLK, BS, BLK, BS)
             * decay[:, None, :, None]).reshape(N, N) for _ in range(count)]


class _Sweep:
    """The sweep's operands, norms and the reference's results, once."""

    def __init__(self):
        self.a64, self.b64 = _operands(2)
        self.an = block_norms(self.a64, BLK, BLK)
        self.bn = block_norms(self.b64, BLK, BLK)
        self.pmax = float(np.max(self.an[:, :, None] * self.bn[None]))
        self.exact = self.a64 @ self.b64
        self._ref = {}

    def ref_product(self, eps):
        if eps not in self._ref:
            mm = RefDistributedMatmul(make_host_mesh(1, 1),
                                      strategy="taskbased", k_blocks=BLK)
            self._ref[eps] = np.asarray(mm(
                jnp.asarray(self.a64, jnp.float32),
                jnp.asarray(self.b64, jnp.float32), a_norms=self.an,
                b_norms=self.bn, filter_eps=eps), np.float64)
        return self._ref[eps]


@pytest.fixture(scope="module")
def sweep():
    return _Sweep()


def _gemms(graph):
    return sum(1 for t in graph.tasks if t.kind == "gemm" and t.flops > 0)


def _plans(sweep, frac):
    """(port plan, reference plan) of ``frac`` on the abstract 16 x 16
    grid, as bench_filter plans them (the eps-0 plan without norms)."""
    eps = frac * sweep.pmax
    kw = dict(a_norms=sweep.an, b_norms=sweep.bn, filter_eps=eps) if eps \
        else {}
    port = plan_matmul(N, N, N, abstract_summa_config(
        BLK, BLK, strategy="taskbased"), **kw)
    ref = ref_plan_matmul(N, N, N, ref_abstract_config(
        BLK, BLK, strategy="taskbased"), **kw)
    return port, ref


def test_norms_equal_the_references(sweep):
    np.testing.assert_array_equal(sweep.an,
                                  ref_block_norms(sweep.a64, BLK, BLK))
    assert sweep.an.dtype == np.float64


def test_eps_zero_digest_is_the_norm_free_plans(sweep):
    """In each package, norms at ``filter_eps=0`` leave the plan bitwise
    as a plan that never saw norms (bench_filter's ``digest_preserved``)."""
    port0 = plan_matmul(N, N, N, abstract_summa_config(
        BLK, BLK, strategy="taskbased"), a_norms=sweep.an, b_norms=sweep.bn,
        filter_eps=0.0)
    ref0 = ref_plan_matmul(N, N, N, ref_abstract_config(
        BLK, BLK, strategy="taskbased"), a_norms=sweep.an, b_norms=sweep.bn,
        filter_eps=0.0)
    port, ref = _plans(sweep, 0.0)
    assert port0.digest() == port.digest()
    assert ref0.digest() == ref.digest()
    assert_plans_equal(port0, ref0)


@pytest.mark.parametrize("frac", FRACS)
def test_plan_matches_reference(sweep, frac):
    """Fields, bound, simulated makespan and gemm tasks equal the
    reference's; filtered never slower than unfiltered in simulation."""
    port, ref = _plans(sweep, frac)
    assert_plans_equal(port, ref)
    assert port.filter_bound == ref.filter_bound
    assert (frac == 0.0) == (port.filter_bound == 0.0)
    graph = from_plan(port)
    assert _gemms(graph) == _gemms(ref_from_plan(ref))
    sim = simulate(graph)
    assert sim.makespan_s == ref_simulate(ref_from_plan(ref)).makespan_s
    base = simulate(from_plan(_plans(sweep, 0.0)[0]))
    assert sim.makespan_s <= base.makespan_s * (1 + 1e-9)


def test_gemm_tasks_never_rise_with_eps(sweep):
    counts = [_gemms(from_plan(_plans(sweep, f)[0])) for f in FRACS]
    assert all(b <= a for a, b in zip(counts, counts[1:])), counts
    assert counts[-1] < counts[0], counts


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
@pytest.mark.parametrize("frac", FRACS)
def test_filtered_product_matches_reference(sweep, frac, local_matmul):
    """C on the 1x1 grid against the reference's C at the kernel
    tolerance, and within ``filter_bound`` + slack of the float64 product
    (the execution plan's bound is the abstract grid plan's)."""
    eps = frac * sweep.pmax
    mm = DistributedMatmul(Grid.local("cpu"), strategy="taskbased",
                           k_blocks=BLK, local_matmul=local_matmul)
    c = mm(torch.from_numpy(sweep.a64.astype(np.float32)),
           torch.from_numpy(sweep.b64.astype(np.float32)), a_norms=sweep.an,
           b_norms=sweep.bn, filter_eps=eps).double().numpy()
    np.testing.assert_allclose(c, sweep.ref_product(eps), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.sqrt(N))
    plan = mm.plan(N, N, N, a_norms=sweep.an, b_norms=sweep.bn,
                   filter_eps=eps)
    assert plan.filter_bound == pytest.approx(
        _plans(sweep, frac)[0].filter_bound, rel=1e-12)
    err = float(np.linalg.norm(c - sweep.exact))
    slack = SLACK * float(np.linalg.norm(sweep.exact))
    assert err <= plan.filter_bound + slack, (frac, err, plan.filter_bound)
    if frac:  # screened: the product differs from the exact one
        assert err > 0.0
        if local_matmul == "pallas":
            assert plan.local_impl == "bsmm"


# ---------------------------------------------------------------------------
# the filtered chain
# ---------------------------------------------------------------------------


class _Chain:
    def __init__(self):
        a, b, c = _operands(3, seed=1)
        self.exact = (a @ b) @ c
        self.c_fro = float(np.linalg.norm(c))
        self.ref_ops = [ref_contract.BlockSparseTensor.from_dense(
            jnp.asarray(x, jnp.float32), block_shape=(BS, BS))
            for x in (a, b, c)]
        self.ops = [pc.BlockSparseTensor(
            data=np.asarray(t.data), tilings=tuple(
                Tiling(tuple(tt.sizes)) for tt in t.tilings))
            for t in self.ref_ops]
        an, bn = self.ref_ops[0].block_norms(), self.ref_ops[1].block_norms()
        self.pmax = float(np.max(an[:, :, None] * bn[None]))

    def port(self, frac):
        return DistributedMatmul(Grid.local("cpu"),
                                 strategy="taskbased").contract_chain(
            [("ik,kj->ij", *self.ops[:2]), ("ik,kj->ij", self.ops[2])],
            filter_eps=frac * self.pmax)

    def ref(self, frac):
        return RefDistributedMatmul(make_host_mesh(1, 1),
                                    strategy="taskbased").contract_chain(
            [("ik,kj->ij", *self.ref_ops[:2]),
             ("ik,kj->ij", self.ref_ops[2])], filter_eps=frac * self.pmax)


@pytest.fixture(scope="module")
def chain():
    return _Chain()


def _pop_bounds(rep):
    bounds = rep.pop("filter_bounds", None)
    plans = [dict(p) for p in rep.pop("plans")]
    return bounds, [p.pop("filter_bound", None) for p in plans], plans


@pytest.mark.parametrize("frac", CHAIN_FRACS)
def test_filtered_chain_matches_reference(chain, frac):
    got, rep = chain.port(frac)
    want, want_rep = chain.ref(frac)
    bounds, pbounds, plans = _pop_bounds(rep)
    want_bounds, want_pbounds, want_plans = _pop_bounds(want_rep)
    np.testing.assert_allclose(bounds, want_bounds, rtol=1e-12)
    np.testing.assert_allclose(pbounds, want_pbounds, rtol=1e-12)
    assert plans == want_plans
    assert rep == want_rep
    assert len(bounds) == 2 and all(b >= 0.0 for b in bounds)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_allclose(got.norms, np.asarray(want.norms),
                               rtol=1e-12)
    data = got.data.double().numpy()
    want_data = np.asarray(want.data, np.float64)
    # the result is not of unit scale: the absolute part at its largest
    np.testing.assert_allclose(
        data, want_data, rtol=KERNEL_TOL,
        atol=KERNEL_TOL * float(np.abs(want_data).max()))
    err = float(np.linalg.norm(data - chain.exact))
    limit = (bounds[0] * chain.c_fro + bounds[1]
             + SLACK * float(np.linalg.norm(chain.exact)))
    assert err <= limit, (frac, err, bounds)


def test_filtered_chain_plans_step_two_on_filtered_structure(chain):
    """Step 2's fill never rises with ``frac`` and falls below the
    unfiltered chain's (the reference's own regression)."""
    _, rep0 = chain.port(0.0)
    prev = rep0["plans"][1]["fill_in"]
    fills = []
    for frac in CHAIN_FRACS:
        res, rep = chain.port(frac)
        fills.append(rep["plans"][1]["fill_in"])
        assert res.mask is not None
    assert all(b <= a + 1e-12 for a, b in zip([prev] + fills, fills))
    assert fills[-1] < prev
