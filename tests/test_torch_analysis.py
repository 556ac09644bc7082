"""``repro_torch.analysis.cost`` against ``repro.analysis.hlo``.

The port counts a call as it dispatches (``CostCounter``); the reference
parses the compiled step's HLO.  At the smoke configs (B = 2, S = 64)
the forward's matrix-product FLOP equal the reference's ``analyze_hlo``
of its jitted forward exactly for all ten archs, and the gradients'
equal or differ by products each side's design explains
(``GRAD_GAPS``).  The reference's roofline formulas hold on the
reference's ``HW``; the weightings (a loop of identical steps, identical
microbatches, identical units, the sLSTM's sequence loop) equal the full
count; the kernel wrappers count the same work on their CPU and ``meta``
routes and as the plain routes they replace; and on a 2x2 grid of gloo
processes a block-sparse product's collective bytes and FLOP shrink with
its dead panels, as ``tests/test_summa.py`` holds the reference's.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
from repro.analysis import hlo as ref_hlo
from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import model as ref_model
from repro_torch.analysis import cost
from repro_torch.configs.registry import get_config
from repro_torch.core.grid import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import LM, forward, init_model, loss_fn

B, S = 2, 64
SMOKE = ShapeConfig("smoke", S, B, "train")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ctx(device="meta"):
    return ParallelCtx(Grid.local(device))


def _ref_specs(arch, labels: bool):
    """The reference's smoke batch as ShapeDtypeStructs, and the port's as
    meta tensors (``dryrun.input_specs``)."""
    cfg = get_config(arch, smoke=True)
    port = dryrun.input_specs(cfg, SMOKE)
    if not labels:
        port.pop("labels")
    ref = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.dtype(
        str(v.dtype).removeprefix("torch."))) for k, v in port.items()}
    return cfg, port, ref


def _ref_flops(fn, *args) -> float:
    return ref_hlo.analyze_hlo(
        jax.jit(fn).lower(*args).compile().as_text()).flops


def _ref_params(arch):
    rcfg = ref_get_config(arch, smoke=True)
    return rcfg, jax.eval_shape(lambda: ref_model.init_model(
        jax.random.PRNGKey(0), rcfg, RefCtx(None)))


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_forward_flops_match_reference(arch):
    """The forward's matrix products, to the FLOP, for all ten archs
    (hubert-xlarge and qwen2-vl-72b on ``input_specs``' embeddings)."""
    assert len(REF_ARCH_IDS) == 10
    cfg, batch, rbatch = _ref_specs(arch, labels=False)
    rcfg, rparams = _ref_params(arch)
    want = _ref_flops(lambda p, b: ref_model.forward(
        p, b, rcfg, RefCtx(None), remat=False)[0], rparams, rbatch)
    _, got, _ = cost.analyze_step(
        lambda m, b: forward(m, b, cfg, _ctx(), remat=False),
        LM(cfg, device="meta"), batch)
    assert got.flops == want > 0


#: The port's gradient FLOP less the reference's at the smoke configs.
#: xlstm-1.3b: the reference's scanned sLSTM step differentiates its
#: recurrent product with respect to the initial state too (one (4, H, B,
#: Dh) x (4, H, Dh, Dh) product, 2·4·H·B·Dh² = 16,384 FLOP), which
#: autograd skips: the initial state needs no gradient.  With remat,
#: XLA drops the recomputed product nothing in the backward reads (a
#: unit's last, its FFN's down projection); the port's recompute stops
#: before it, because ``matmul_f32`` saves its operands before it
#: computes (``layers.fill_after_node``).
def _slstm_initial_state_product(cfg) -> int:
    dh = cfg.d_model // cfg.num_heads
    return 2 * 4 * cfg.num_heads * B * dh * dh


@pytest.mark.parametrize("arch,remat", [
    ("llama3.2-1b", False), ("mixtral-8x7b", False),
    ("recurrentgemma-9b", False), ("xlstm-1.3b", False),
    ("llama3.2-1b", True), ("mixtral-8x7b", True),
    ("recurrentgemma-9b", True), ("xlstm-1.3b", True),
    ("kimi-k2-1t-a32b", False), ("kimi-k2-1t-a32b", True)])
def test_gradient_flops_against_reference(arch, remat):
    """llama, mixtral, kimi-k2 (its shared expert's down projection is its
    units' last product) and recurrentgemma count the reference's gradient
    FLOP exactly, with remat and without: the remat backward does not
    recompute a unit's last product; xlstm-1.3b 16,384 fewer (the initial
    state's gradient, see above)."""
    cfg, batch, rbatch = _ref_specs(arch, labels=True)
    rcfg, rparams = _ref_params(arch)
    want = _ref_flops(jax.grad(lambda p, b: ref_model.loss_fn(
        p, b, rcfg, RefCtx(None), remat=remat)[0]), rparams, rbatch)
    model = LM(cfg, device="meta").requires_grad_(True)
    batch = {k: v.long() for k, v in batch.items()}
    _, got, _ = cost.analyze_step(
        lambda m, b: loss_fn(m, b, cfg, _ctx(), remat=remat)[0].backward(),
        model, batch)
    gap = got.flops - want
    if arch == "xlstm-1.3b":
        assert gap == -_slstm_initial_state_product(cfg) == -16_384
    else:
        assert gap == 0


def test_reference_formulas_on_the_reference_hw():
    """``wire_bytes`` and ``roofline`` are the reference's, given the
    reference's ``HW``; the port's default is the card's."""
    rng = np.random.default_rng(0)
    for group in (2, 4, 16, 32):
        by_op = {op: float(rng.integers(0, 2**40))
                 for op in ref_hlo.COLLECTIVE_OPS}
        assert cost.wire_bytes(by_op, group) == ref_hlo.wire_bytes(
            by_op, group)
    ref_hw = ref_hlo.HW()
    hw = cost.HW(ref_hw.peak_flops, ref_hw.hbm_bw, ref_hw.ici_bw)
    for args in ((197e12, 819e9 / 2, 0.0, 4, 4 * 197e12 * 0.8),
                 (1e15, 3e12, 7e11, 256, 5e16), (0.0, 1.0, 2.0, 1, 0.0)):
        got = cost.roofline(*args, hw=hw).row()
        assert got == ref_hlo.roofline(*args, hw=ref_hw).row()
    assert cost.DEFAULT_HW.peak_flops == 989e12
    assert cost.DEFAULT_HW.hbm_bw == 3.35e12
    assert cost.DEFAULT_HW.ici_bw == 450e9
    # the port's extra kind: a broadcast costs one result on the wire
    assert cost.wire_bytes({"broadcast": 8.0}) == 8.0


# ---------------------------------------------------------------------------
# weighting
# ---------------------------------------------------------------------------


def test_python_loop_counts_n_times():
    """The ports of ``test_synthetic_module_weighting`` and
    ``test_real_scan_weighting``: a Python loop of n products counts n
    times one (its collectives too), and ``weighted(n)`` of one step
    counts the same as the loop."""
    x = torch.ones(8, 8)
    one_dot = 2 * 8 * 8 * 8

    def body(x):
        d = x @ x
        cost.report_collective("all-reduce", d)
        return d

    def loop(x):
        for _ in range(5):
            x = body(x)
        return x @ x

    _, wc, _ = cost.analyze_step(loop, x)
    assert wc.flops == 5 * one_dot + one_dot
    assert wc.coll_bytes_by_op["all-reduce"] == 5 * 8 * 8 * 4
    assert wc.coll_counts_by_op["all-reduce"] == 5

    def weighted(x):
        with cost.active_counter().weighted(5):
            x = body(x)
        return x @ x

    _, ww, _ = cost.analyze_step(weighted, x)
    assert (ww.flops, ww.hbm_bytes, ww.coll_bytes_by_op) == (
        wc.flops, wc.hbm_bytes, wc.coll_bytes_by_op)

    n, d = 7, 64
    y = torch.ones(d, d, device="meta")

    def scan(c):
        for _ in range(n):
            c = torch.matmul(c, c)
        return c

    _, ws, _ = cost.analyze_step(scan, y)
    assert ws.flops == n * 2 * d**3


def _counts(wc, mem):
    return (wc.flops, wc.hbm_bytes, wc.coll_bytes, mem.argument_size_in_bytes,
            mem.peak_live_bytes)


def _times():
    return {"lower_s": 0.0, "compile_s": 0.0}


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatch_weighting_equals_the_full_step(microbatches):
    """One microbatch counted ``microbatches`` times and the update once
    (the dry run's train cell) equals the whole step counted as it runs;
    its peak differs only by the previous microbatch's four metric
    scalars, which the whole step holds while the next one runs."""
    cfg = get_config("llama3.2-1b", smoke=True)
    shape = ShapeConfig("t", 32, 8, "train")
    ctx = dryrun.make_ctx(Grid.local("meta"), False)
    step, (state, batch) = dryrun.build_train_cell(cfg, shape, ctx,
                                                   microbatches)
    _, full, full_mem = cost.analyze_step(step, state, batch)
    got, mem, _ = dryrun._count_one(cfg, shape, ctx, microbatches, _times())
    assert _counts(got, mem)[:4] == _counts(full, full_mem)[:4]
    assert got.by_op == full.by_op
    assert 0 <= full_mem.peak_live_bytes - mem.peak_live_bytes <= 4 * 4


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b",
                                  "mixtral-8x7b"])
def test_unit_weighting_equals_the_full_count(arch, kind):
    """count(L) = count(1) + (L - 1)·(count(2) - count(1)) equals the count
    of the model of L units (recurrentgemma's tail kept), its FLOP, bytes
    and argument bytes exactly; the peak is a linear estimate."""
    cfg = dryrun.with_units(get_config(arch, smoke=True), 4)
    shape = ShapeConfig("u", 16, 4, kind)
    ctx = dryrun.make_ctx(Grid.local("meta"), False)
    full, full_mem = dryrun._count_model(cfg, shape, ctx, 2, _times())
    got, mem = dryrun.count_cell(cfg, shape, ctx, 2)
    assert _counts(got, mem)[:4] == _counts(full, full_mem)[:4]
    assert got.by_op == full.by_op
    assert mem.peak_live_bytes == pytest.approx(full_mem.peak_live_bytes,
                                                rel=0.1)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_loop_weighting_equals_the_full_count(kind):
    """The sLSTM's loop over S counted from runs of one and two steps
    equals running all S steps: FLOP, bytes and memory, forward and
    backward."""
    cfg = get_config("xlstm-1.3b", smoke=True)
    shape = ShapeConfig("l", 24, 2, kind)
    ctx = dryrun.make_ctx(Grid.local("meta"), False)
    full, full_mem, trips = dryrun._count_one(cfg, shape, ctx, 1, _times())
    assert not trips  # no sampling asked: every step ran
    got, mem = dryrun._count_model(cfg, shape, ctx, 1, _times())
    assert _counts(got, mem) == _counts(full, full_mem)
    assert got.by_op == full.by_op
    with pytest.raises(ValueError, match="meta only"):
        cost.CostCounter("cpu", sample_loops=1)


# ---------------------------------------------------------------------------
# the kernels: one count on every route
# ---------------------------------------------------------------------------


def _forward_cost(arch, use_kernel, device, layers=1):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              num_layers=layers)
    model = (LM(cfg, device="meta") if device == "meta" else
             init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu"))
    tokens = torch.zeros((B, S), dtype=torch.int64, device=device)
    _, wc, _ = cost.analyze_step(
        lambda m, t: forward(m, {"tokens": t}, cfg, _ctx(device),
                             use_kernel=use_kernel, remat=False),
        model, tokens)
    return wc


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("arch,kernels", [
    ("llama3.2-1b", {"flash_attention": 1}),
    ("mixtral-8x7b", {"flash_attention": 1, "grouped_gemm": 3})])
def test_kernel_and_plain_routes_count_the_same_flops(arch, kernels, device):
    """``use_kernel=True`` counts the FLOP of the plain route it replaces:
    attention's two products and the MoE block's three expert einsums;
    the kernels' bytes are their operands and results only."""
    plain = _forward_cost(arch, False, device)
    kern = _forward_cost(arch, True, device)
    assert kern.flops == plain.flops
    assert kern.hbm_bytes < plain.hbm_bytes
    for name, calls in kernels.items():
        assert kern.by_op[name][0] == calls
        assert name not in plain.by_op


def _wrapper_cases():
    """name -> (call on a device, FLOP, bytes: operands, index map and
    result, each once)."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(96, 64, generator=g)
    b = torch.randn(64, 40, generator=g)
    mask = np.array([[1, 0], [1, 1], [0, 0]], bool)  # 3 live blocks
    cols = np.array([[1, -1], [0, 1]], np.int32)  # 3 live entries
    tiles = np.array([[[1, -1], [0, 1]], [[-1, -1], [0, -1]]], np.int32)
    x = torch.randn(48, 32, generator=g)
    w = torch.randn(3, 32, 24, generator=g)
    te = np.array([2, 0, 2], np.int32)
    q = torch.randn(2, 4, 20, 8, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 2, 20, 8, generator=g).to(torch.bfloat16)
    b300 = torch.randn(64, 300, generator=g)
    return {
        "tiled_matmul": (lambda d: ops.tiled_matmul(a.to(d), b.to(d)),
                         2.0 * 96 * 40 * 64, 4 * (96 * 64 + 64 * 40 + 96 * 40)),
        "bsmm": (lambda d: ops.bsmm(a.to(d), b.to(d), mask, bn=8),
                 2.0 * 3 * 32 * 32 * 40,
                 4 * (96 * 64 + 64 * 40 + 3 * 2 + 96 * 40)),
        "bsmm_cols": (lambda d: ops.bsmm_cols(
            a[:64].to(d), b.to(d), cols, bm=32, bk=32, bn=8),
            2.0 * 3 * 32 * 32 * 40, 4 * (64 * 64 + 64 * 40 + 2 * 2 + 64 * 40)),
        # a tile map over N = 300: tiles of 256 and 44 columns; lists of 1
        # and 2 entries in block row 0, 0 and 1 in block row 1
        "bsmm_tile_cols": (lambda d: ops.bsmm_cols(
            a[:64].to(d), b300.to(d), tiles, bm=32, bk=32, bn=4),
            2.0 * 32 * 32 * (256 + 2 * 44 + 44),
            4 * (64 * 64 + 64 * 300 + 2 * 2 * 2 + 64 * 300)),
        "grouped_gemm": (lambda d: ops.grouped_gemm(
            x.to(d), w.to(d), te, bt=16, out_dtype=torch.bfloat16),
            2.0 * 48 * 32 * 24, 4 * (48 * 32 + 3 * 32 * 24 + 3) + 2 * 48 * 24),
        "flash_attention": (lambda d: ops.flash_attention(
            q.to(d), k.to(d), k.to(d), causal=True, window=6),
            4.0 * 2 * 4 * 20 * 20 * 8, 2 * (2 * 2 * 4 * 20 * 8
                                             + 2 * 2 * 2 * 20 * 8)),
    }


@pytest.mark.parametrize("case", list(_wrapper_cases()))
def test_wrapper_meta_route_counts_as_the_plain_version(case):
    """Each wrapper on ``meta``: the plain version's shape and dtype, and
    the same reported work (one call, its FLOP and bytes) as on the
    CPU."""
    fn, flops, nbytes = _wrapper_cases()[case]
    name = "bsmm" if case.startswith("bsmm") else case
    outs, costs = {}, {}
    for device in ("cpu", "meta"):
        out, wc, _ = cost.analyze_step(fn, device, device=device)
        outs[device], costs[device] = out, wc.by_op[name]
    assert outs["meta"].device.type == "meta"
    assert outs["meta"].shape == outs["cpu"].shape
    assert outs["meta"].dtype == outs["cpu"].dtype
    assert costs["meta"] == costs["cpu"] == [1.0, flops, nbytes]


def test_meta_route_refuses_what_the_kernel_refuses():
    with pytest.raises(ValueError, match="expert outside"):
        ops.grouped_gemm(torch.empty(32, 8, device="meta"),
                         torch.empty(2, 8, 4, device="meta"), [0, 2], bt=16)
    with pytest.raises(ValueError, match="head widths"):
        ops.flash_attention(*(torch.empty(1, 1, 4, 300, device="meta"),) * 3)
    with pytest.raises(ValueError, match="block column"):
        ops.bsmm_cols(torch.empty(32, 32, device="meta"),
                      torch.empty(32, 8, device="meta"),
                      np.array([[1]], np.int32), bm=32, bk=32, bn=8)


def test_counter_limits_itself_to_its_device():
    """Host scratch (a numpy index map, a CPU scalar) is not the card's
    work: a counter on ``meta`` counts only what touches ``meta``, its
    copy to the device included."""
    x = torch.empty(16, 16, device="meta")

    def fn(x):
        idx = torch.as_tensor(np.arange(4))  # host only
        (idx + 1).sum().item()
        return x[idx.to(x.device)] * 2.0

    _, wc, mem = cost.analyze_step(fn, x)
    assert set(wc.by_op) == {"aten._to_copy", "aten.index", "aten.mul"}
    assert mem.argument_size_in_bytes == 16 * 16 * 4
    # the argument, then the gathered rows and their product (the index
    # map's device copy is freed once the gather has read it)
    assert mem.peak_live_bytes == 16 * 16 * 4 + 2 * 4 * 16 * 4


# ---------------------------------------------------------------------------
# collectives on a 2x2 grid of gloo processes
# ---------------------------------------------------------------------------

_DEAD_PANELS = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.analysis.cost import analyze_step
from repro_torch.core import Grid
from repro_torch.core.sparsity import random_block_mask
from repro_torch.core.plan import plan_matmul
from repro_torch.core.summa import (SummaConfig, execute_plan, gather_tiles,
                                    local_tile, reference_blocksparse_matmul)

rank, rdv = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
grid = Grid.from_process_group(2, 2, device="cpu")
cfg = SummaConfig(grid=grid, strategy="taskbased", k_blocks=8)
a = torch.ones((64, 128))
b = torch.ones((128, 64))
am = random_block_mask(8, 8, 0.5, seed=0)
bm = random_block_mask(8, 8, 0.5, seed=1)
am[:, 2] = False  # dead K panels (screened-out interaction blocks)
am[:, 5] = False
bm[6, :] = False
alive = [k for k in range(8) if am[:, k].any() and bm[k, :].any()]
assert len(alive) == 5, alive
a_loc, b_loc = local_tile(a, cfg), local_tile(b, cfg)


def count(am, bm):
    # the per-rank program (the reference's shard_map body): C stays
    # sharded, as the reference's compiled product leaves it
    plan = plan_matmul(64, 128, 64, cfg, a_mask=am, b_mask=bm, itemsize=4)
    return analyze_step(execute_plan, a_loc, b_loc, plan)


c_loc, cs, _ = count(am, bm)
_, cf, _ = count(np.ones_like(am), np.ones_like(bm))
got = gather_tiles(c_loc, cfg)
# communication AND compute scale with the number of live panels
assert 0 < cs.coll_bytes <= cf.coll_bytes * (len(alive) / 8 + 0.05), (
    cs.coll_bytes, cf.coll_bytes)
assert 0 < cs.flops <= cf.flops * (len(alive) / 8 + 0.05), (cs.flops,
                                                            cf.flops)
assert cs.coll_counts_by_op["broadcast"] < cf.coll_counts_by_op["broadcast"]
want = reference_blocksparse_matmul(a, b, am, bm)
assert (got - want).abs().max().item() < 1e-4
print("DEAD_PANELS_OK", rank, cs.coll_bytes, cf.coll_bytes, cs.flops,
      cf.flops)
dist.destroy_process_group()
"""


def test_blocksparse_skips_dead_panels(tmp_path):
    """The port of ``tests/test_summa.py::
    test_blocksparse_skips_dead_panels`` on a 2x2 grid of gloo processes:
    each rank's counted collective bytes and FLOP of the block-sparse
    product are at most 5/8 + 0.05 of the all-live product's."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DEAD_PANELS, str(rank),
         str(tmp_path / "rdv")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    assert all("DEAD_PANELS_OK" in log for log in logs)
