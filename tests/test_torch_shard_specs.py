"""The sharding rules without processes: blocks, the counting grid, head
layouts, and the dry run's per-device count against the reference's.

* ``dist.partitioning.shard_params`` on every rank of the 2x2 and 2x4
  planning grids: each block is the whole parameter's block under its
  validated spec, the blocks put back together are the parameter
  bitwise, and a rank holds the bytes ``launch.serve.param_bytes``
  reports (the spec's share);
* ``Grid.fsdp_gather`` on a counting grid (``meta``): an all-gather
  forward, a reduce-scatter backward, each reported to the counter;
* every collective of a counting grid: its result's shape and the bytes
  it reports, tuple axes included;
* the attention's head layout (``models.attention._heads``) on every
  rank: q and kv heads split where they divide, and at tp = 4 on
  llama3.2-1b's SMOKE config (8 q / 2 kv heads) the kv heads each
  rank's q heads read;
* a dim that does not divide its axis group stays whole, and the
  compute reads the validated spec (``ParallelCtx.tp_sharded``);
* ``launch.dryrun``'s per-device FLOP for llama3.2-1b SMOKE, train and
  prefill, on the 2x2 grid against the reference's ``analyze_hlo``
  ``flops_per_device`` of the same cells compiled on a 2x2 host mesh (a
  subprocess of four host devices), within 5 % of the port's figure;
  bytes and collective bytes are printed beside it, not held (GSPMD picks
  its own collectives).  The port splits every product evenly: its
  per-device FLOP is the one-device count over four, exactly; GSPMD
  computes the attention's output projection unsplit over ``model``
  (after gathering the heads), which the 5 % covers at these sequence
  lengths.
"""
import copy
import json
import math

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.analysis import cost
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist.context import ParallelCtx
from repro_torch.dist.partitioning import (_leaf_spec, param_shardings,
                                           shard_params)
from repro_torch.launch import dryrun
from repro_torch.launch import serve
from repro_torch.models.attention import _heads
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import init_model

GRIDS = ((2, 2), (2, 4))
ARCHS = ("llama3.2-1b", "qwen2.5-32b", "mixtral-8x7b", "xlstm-1.3b")
#: the cells held against the reference's per-device FLOP: long enough
#: sequences that the attention, which both split evenly, dominates
FLOP_CELLS = {
    "train": (ShapeConfig("train_4k", 128, 4, "train"), 2),
    "prefill": (ShapeConfig("prefill_32k", 512, 2, "prefill"), 1),
}


def _coords(sizes):
    return [tuple(int(c) for c in np.unravel_index(r, sizes))
            for r in range(math.prod(sizes))]


def _model(arch, ep):
    cfg = get_config(arch, smoke=True)
    return cfg, init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", ep=ep)


@pytest.mark.parametrize("sizes", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_round_trip_bitwise(arch, sizes):
    """Every rank's blocks, put back at their offsets, are the whole
    parameters bitwise; each rank holds the spec's share of the bytes."""
    cfg, model = _model(arch, sizes[1])
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in whole.items()}
    specs = param_shardings(shapes, Grid(sizes=sizes))
    rebuilt = {n: torch.full_like(p, float("nan")) for n, p in whole.items()}
    _, want_share = serve.param_bytes(model, Grid(sizes=sizes))
    for coords in _coords(sizes):
        grid = Grid(sizes=sizes, coords=coords, device=torch.device("cpu"))
        rank = shard_params(copy.deepcopy(model), grid)
        assert serve.param_bytes(rank, grid)[1] == want_share
        for name, p in rank.named_parameters():
            assert p.full_shape == shapes[name]
            spec = specs[name] + (None,) * (p.ndim - len(specs[name]))
            assert p.spec == spec, name
            index = []
            for dim, entry in enumerate(spec):
                n = p.shape[dim]
                at = grid.axis_index(entry) if entry is not None else 0
                index.append(slice(at * n, (at + 1) * n))
            rebuilt[name][tuple(index)] = p.detach()
    for name, p in whole.items():
        assert torch.equal(rebuilt[name], p), name


def test_fsdp_gather_backward_is_a_reduce_scatter():
    """On the counting grid: the gathered shape forward, the block's shape
    back, an all-gather and a reduce-scatter reported."""
    grid = Grid(sizes=(2, 4), device=torch.device("meta"))
    x = torch.empty((3, 5), device="meta", requires_grad=True)
    counter = cost.CostCounter("meta")
    with counter:
        y = grid.fsdp_gather(x, "model", 0)
        assert y.shape == (12, 5)
        y.backward(torch.empty_like(y))
    assert x.grad.shape == (3, 5)
    wc = counter.cost()
    assert wc.coll_bytes_by_op["all-gather"] == 12 * 5 * 4
    assert wc.coll_bytes_by_op["reduce-scatter"] == 3 * 5 * 4
    assert wc.coll_counts_by_op["all-gather"] == 1
    assert wc.coll_counts_by_op["reduce-scatter"] == 1


@pytest.mark.parametrize("axis", ["model", "data", ("data", "model"),
                                  ("model", "data")])
def test_counting_grid_collectives(axis):
    """Each collective's result shape on the counting grid, and the bytes
    it reports (its result on this rank); axes of one rank report
    nothing."""
    grid = Grid(sizes=(2, 4), coords=(1, 2), device=torch.device("meta"))
    assert grid.counting and not Grid(sizes=(2, 4)).counting
    p = grid.axis_size(axis)
    x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    counter = cost.CostCounter("meta")
    with counter:
        outs = {
            "all-gather": grid.all_gather(x, axis, 1),
            "reduce-scatter": grid.reduce_scatter(x, axis, 0),
            "all-reduce": grid.all_reduce(x, axis),
            "broadcast": grid.broadcast(x, 0, axis)[0],
            "collective-permute": grid.ring_shift(x, axis)[0],
        }
    assert outs["all-gather"].shape == (8, 6 * p)
    assert outs["reduce-scatter"].shape == (8 // p, 6)
    for kind in ("all-reduce", "broadcast", "collective-permute"):
        assert outs[kind].shape == (8, 6)
    wc = counter.cost()
    for kind, out in outs.items():
        assert out.device.type == "meta"
        assert wc.coll_bytes_by_op[kind] == out.numel() * 2, kind
        assert wc.coll_counts_by_op[kind] == 1
    one = Grid(sizes=(1, 4), device=torch.device("meta"))
    counter = cost.CostCounter("meta")
    with counter:
        assert one.all_gather(x, "data", 0) is x
    assert sum(counter.cost().coll_bytes_by_op.values()) == 0


def test_planning_grid_off_meta_has_no_collectives():
    """A planning grid that is not on ``meta`` counts nothing and runs
    nothing: a collective over an axis with peers raises."""
    with pytest.raises(RuntimeError, match="no process group"):
        Grid(sizes=(2, 2), device=torch.device("cpu")).all_reduce(
            torch.ones(2), "data")


@pytest.mark.parametrize("tp", [2, 4])
def test_head_layout_on_every_rank(tp):
    """llama3.2-1b SMOKE (8 q / 2 kv heads): at tp = 2 both split; at
    tp = 4 the kv heads are whole and each rank keeps the one its two q
    heads read (q heads 2r, 2r + 1 read kv head r // 2)."""
    cfg, model = _model("llama3.2-1b", tp)
    for coords in _coords((1, tp)):
        grid = Grid(sizes=(1, tp), coords=coords, device=torch.device("cpu"))
        rank = shard_params(copy.deepcopy(model), grid)
        attn = rank.units[0]["b0"].attn
        hq, hkv, kv = _heads(attn, cfg, ParallelCtx(grid))
        assert hq
        if tp == 2:
            assert hkv and kv is None
        else:
            assert not hkv and kv == [coords[1] // 2]
            # wk's columns are split over tp, not along heads: gathered
            assert attn.wk.w.spec[1] == "model"


def test_a_dim_that_does_not_divide_stays_whole():
    """A vocab of 514 on tp = 4: the embedding's vocab dim falls back to
    replicated (its D stays over ``data``), the rank holds it whole, and
    the forward reads the validated spec: its logits keep every column."""
    import dataclasses

    from repro_torch.models.model import vocab_part

    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              vocab_size=514)
    model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", ep=4)
    name = "embed.embedding"
    assert _leaf_spec(name, (514, 64)) == ("model", "data")
    grid = Grid(sizes=(2, 4), coords=(1, 3), device=torch.device("cpu"))
    shard_params(model, grid)
    emb = model.embed.embedding
    assert emb.spec == (None, "data") and tuple(emb.shape) == (514, 32)
    ctx = ParallelCtx(grid)
    assert not ctx.tp_sharded(emb, 0)
    assert vocab_part(model, cfg, ctx) is None
    # a dim that divides is split on the same grid
    assert model.units[0]["b0"].ffn.w_up.w.spec == ("data", "model")


_REF_FLOPS = r"""
import json
import jax
jax.devices()  # four host devices, before the reference's dry run sets 512
from repro.analysis import hlo as hloa
from repro.configs.registry import get_config
from repro.launch import dryrun as rd
from repro.launch.mesh import make_host_mesh
from repro.models.config import ShapeConfig
cells = json.loads('CELLS')
mesh = make_host_mesh(2, 2)
ctx = rd.make_ctx(mesh, False)
cfg = get_config("llama3.2-1b", smoke=True)
out = {}
for name, (shape, mb) in cells.items():
    shape = ShapeConfig(*shape)
    with mesh:
        if shape.kind == "train":
            fn, args = rd.build_train_cell(cfg, shape, ctx, mb)
        else:
            fn, args = rd.build_prefill_cell(cfg, shape, ctx)
        wc = hloa.analyze_hlo(fn.lower(*args).compile().as_text())
    out[name] = [wc.flops, wc.hbm_bytes, wc.coll_bytes]
print(json.dumps(out))
"""


def test_per_device_flops_against_reference_on_a_2x2_mesh():
    cells = {k: [[s.name, s.seq_len, s.global_batch, s.kind], mb]
             for k, (s, mb) in FLOP_CELLS.items()}
    ref = json.loads(run_subprocess(
        _REF_FLOPS.replace("CELLS", json.dumps(cells)), devices=4,
        timeout=600).strip().splitlines()[-1])
    cfg = get_config("llama3.2-1b", smoke=True)
    ctx = dryrun.make_ctx(Grid(sizes=(2, 2), device=torch.device("meta")),
                          False)
    one = dryrun.make_ctx(Grid.local("meta"), False)
    for name, (shape, mb) in FLOP_CELLS.items():
        wc, _ = dryrun.count_cell(cfg, shape, ctx, mb)
        whole, _ = dryrun.count_cell(cfg, shape, one, mb)
        flops, hbm, coll = ref[name]
        print(f"{name}: port {wc.flops:.6g} FLOP, {wc.hbm_bytes:.6g} B, "
              f"{wc.coll_bytes:.6g} B collective; reference {flops:.6g} "
              f"FLOP, {hbm:.6g} B, {coll:.6g} B collective")
        assert wc.flops * 4 == whole.flops
        assert abs(flops - wc.flops) <= 0.05 * wc.flops, (name, flops,
                                                          wc.flops)
        assert wc.coll_bytes > 0
