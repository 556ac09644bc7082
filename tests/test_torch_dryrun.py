"""``repro_torch.launch.dryrun`` against ``repro.launch.dryrun``.

The reference compiles each cell for a 256- or 512-chip mesh; these
tests hold what the port computes from shapes alone, with no compile and
no such mesh: the input specs, the model FLOPs, the contexts, the
simulated schedules of the production grids (the reference's on an
``AbstractMesh`` of the same axes), and the argument bytes a rank holds
under the spec tuples, against the same arithmetic on the reference's
``NamedSharding`` specs.  ``run_cell`` runs every arch at smoke size on
the card's grid, and the CLI writes one JSON a cell with the reference's
keys.
"""
import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS)

if _XLA_FLAGS is None:  # the reference's module sets a 512-device flag for
    os.environ.pop("XLA_FLAGS", None)  # its own process; keep it out of
else:  # this one's subprocesses
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.dist import partitioning as ref_part  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.models.config import ShapeConfig as RefShape  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import train_step as ref_ts  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_grid  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

#: the keys the reference's ``run_cell`` writes for a compiled cell
#: (src/repro/launch/dryrun.py: the result dict, ``sched`` and the
#: ``result.update``), less ``xla_cost_analysis``
REF_KEYS = {
    "arch", "shape", "mesh", "matmul_strategy", "attention_impl",
    "mlstm_chunk", "zero1", "kv_quant", "microbatches", "status", "lower_s",
    "compile_s", "chips", "flops_per_device", "hbm_bytes_per_device",
    "collective_bytes_per_device", "collective_wire_bytes_per_device",
    "collective_breakdown", "collective_counts", "roofline",
    "memory_analysis",
}
#: shapes of the same names and kinds, cut for the CPU
SMALL_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 16, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32, 4, "decode"),
    "long_500k": ShapeConfig("long_500k", 64, 1, "decode"),
}


def _abstract_mesh(multi_pod: bool) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def test_production_grid():
    for multi_pod, sizes in ((False, (16, 16)), (True, (2, 16, 16))):
        grid = make_production_grid(multi_pod=multi_pod)
        mesh = _abstract_mesh(multi_pod)
        assert grid.sizes == sizes
        assert grid.shape == dict(mesh.shape)
        with pytest.raises(ValueError, match="planning-only"):
            grid.check_world()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_and_model_flops_match_reference(shape):
    assert set(SHAPES) == set(REF_SHAPES)
    for arch in REF_ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        got = dryrun.input_specs(cfg, SHAPES[shape])
        want = ref_dryrun.input_specs(rcfg, REF_SHAPES[shape])
        assert set(got) == set(want), arch
        for k, x in got.items():
            assert x.device.type == "meta"
            assert tuple(x.shape) == want[k].shape, (arch, k)
            assert str(x.dtype).removeprefix("torch.") == str(
                want[k].dtype), (arch, k)
        assert dryrun.model_flops_per_step(cfg, SHAPES[shape]) == \
            ref_dryrun.model_flops_per_step(rcfg, REF_SHAPES[shape])


def test_make_ctx_matches_reference():
    for multi_pod in (False, True):
        grid = make_production_grid(multi_pod=multi_pod)
        mesh = _abstract_mesh(multi_pod)
        for kw in ({}, {"pure_dp": True}, {"matmul_strategy": "summa",
                                           "zero1": True, "kv_quant": True},
                   {"attention_impl": "chunked", "mlstm_chunk": 64,
                    "slstm_replicated": True}):
            got = dryrun.make_ctx(grid, multi_pod, **kw)
            want = ref_dryrun.make_ctx(mesh, multi_pod, **kw)
            for f in ("dp_axes", "tp_axis", "matmul_strategy",
                      "attention_impl", "mlstm_chunk", "zero1", "kv_quant",
                      "slstm_replicated", "pure_dp", "dp", "dp_size",
                      "tp_size"):
                assert getattr(got, f) == getattr(want, f), (f, kw)


@pytest.mark.parametrize("strategy,multi_pod", [
    ("summa", False), ("summa", True), ("auto", False)])
def test_sched_section_matches_reference(strategy, multi_pod):
    """The projections' plans and simulated schedules on the production
    grids, planned from shapes (the reference's on an abstract mesh).
    The tuner's ``auto`` cell runs on the 16x16 grid only: on 2x16x16 it
    takes ~40 s a package on this CPU."""
    shape = ShapeConfig("train_4k", 64, 32, "train")
    cfg = get_config("llama3.2-1b", smoke=True)
    rcfg = ref_get_config("llama3.2-1b", smoke=True)
    got = dryrun.sched_section(
        cfg, shape, dryrun.make_ctx(make_production_grid(
            multi_pod=multi_pod), multi_pod, strategy), 16)
    want = ref_dryrun.sched_section(
        rcfg, _ref_shape(shape),
        ref_dryrun.make_ctx(_abstract_mesh(multi_pod), multi_pod, strategy),
        16)
    assert got and got == want
    assert (got[0]["tuned"] is not None) == (strategy == "auto")


def _ref_shape(shape: ShapeConfig) -> RefShape:
    return RefShape(shape.name, shape.seq_len, shape.global_batch,
                    shape.kind)


def _ref_rank_bytes(tree, shardings, mesh) -> int:
    specs = jax.tree.leaves(shardings,
                            is_leaf=lambda x: isinstance(x, NamedSharding))
    leaves = jax.tree.leaves(tree)
    assert len(specs) == len(leaves)
    return sum(dryrun.rank_bytes(x.shape, np.dtype(x.dtype).itemsize,
                                 tuple(sh.spec), dict(mesh.shape))
               for x, sh in zip(leaves, specs))


def _ref_argument_bytes(rcfg, shape, rctx) -> int:
    """The same arithmetic on the reference's abstract arguments and their
    ``NamedSharding`` specs."""
    mesh = rctx.mesh
    batch = ref_dryrun.input_specs(rcfg, _ref_shape(shape))
    if shape.kind == "train":
        opt = ref_dryrun.make_optimizer(ref_dryrun.OptimizerConfig(
            name="adafactor" if rcfg.name.startswith("kimi") else "adamw"))
        state = ref_ts.abstract_train_state(jax.random.PRNGKey(0), rcfg,
                                            rctx, opt)
        return (_ref_rank_bytes(state, ref_ts.state_shardings(state, rctx),
                                mesh)
                + _ref_rank_bytes(batch, ref_ts.batch_shardings(batch, rctx),
                                  mesh))
    params = jax.eval_shape(lambda: ref_model.init_model(
        jax.random.PRNGKey(0), rcfg, rctx))
    out = _ref_rank_bytes(params, ref_part.param_shardings(params, mesh),
                          mesh)
    if shape.kind == "prefill":
        batch.pop("labels")
        return out + _ref_rank_bytes(
            batch, ref_ts.batch_shardings(batch, rctx), mesh)
    b = shape.global_batch
    cache = jax.eval_shape(lambda: ref_engine.init_cache(
        rcfg, b, shape.seq_len, kv_quant=rctx.kv_quant))
    tokens = jax.ShapeDtypeStruct((b,), np.int32)
    t_sh = NamedSharding(mesh, PartitionSpec(
        rctx.dp if b % rctx.dp_size == 0 else None))
    # the port's cache counts positions in int64 where the reference's are
    # int32 (serve/engine.py): the same spec over twice the bytes
    pos = cache["pos"]
    cache["pos"] = jax.ShapeDtypeStruct(pos.shape, np.int64)
    return (out + _ref_rank_bytes(
        cache, ref_engine.cache_shardings(cache, rctx, b), mesh)
            + _ref_rank_bytes(tokens, t_sh, mesh))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "xlstm-1.3b", "kimi-k2-1t-a32b",
                                  "qwen2-vl-72b"])
def test_argument_bytes_per_rank_match_reference(arch, kind):
    """Per-rank argument bytes of the train state (ZeRO-1 too), the
    parameters, the batch and the cache, from the spec tuples over the
    production grids' sizes, equal the same arithmetic on the reference's
    specs of its abstract arguments (experts padded for tp = 16)."""
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch,
                                                              smoke=True)
    shape = ShapeConfig("cell", 64, 64, kind)
    for multi_pod in (False, True):
        for kw in ({}, {"zero1": True, "kv_quant": True}):
            ctx = dryrun.make_ctx(make_production_grid(multi_pod=multi_pod),
                                  multi_pod, **kw)
            rctx = ref_dryrun.make_ctx(_abstract_mesh(multi_pod), multi_pod,
                                       **kw)
            got = dryrun.argument_bytes_per_rank(cfg, shape, ctx)
            assert got == _ref_argument_bytes(rcfg, shape, rctx), (
                multi_pod, kw)


def test_cache_shardings_engine_is_the_only_impl():
    """The dryrun duplicate must delegate to the engine's classifier
    (the reference's tests/test_serve.py holds the same)."""
    cfg = get_config("xlstm-1.3b", smoke=True)
    ctx = dryrun.make_ctx(make_production_grid(), False)
    cache = engine.init_cache(cfg, 32, 16, device="meta")
    assert dryrun._cache_shardings(cache, ctx, 32) == engine.cache_shardings(
        cache, ctx, 32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_on_every_arch(arch, monkeypatch):
    """Every shape of every arch at smoke size on the card's grid: counted
    and finite, the reference's statuses for the skipped cells; the
    production grids record schedules, argument bytes and rank 0's
    per-device count."""
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    for shape in SMALL_SHAPES:
        res = dryrun.run_cell(arch, shape, "1", smoke=True, microbatches=2)
        skip = ref_dryrun.cell_skip_reason(arch, shape)
        if skip:
            assert res["status"] == skip
            continue
        assert res["status"] == "ok", res
        assert set(res) == REF_KEYS
        assert res["flops_per_device"] > 0
        assert res["roofline"]["bound_s"] > 0
        assert res["collective_bytes_per_device"] == 0  # one rank
        mem = res["memory_analysis"]
        assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"] > 0
        if shape == "train_4k":
            assert res["microbatches"] == 2
        prod = dryrun.run_cell(arch, shape, True, smoke=True,
                               matmul_strategy="summa")
        assert prod["mesh"] == "2x16x16" and prod["chips"] == 512
        # rank 0's program counted on the production grid: a share of
        # the one-rank count, its collectives, its peak memory
        assert set(REF_KEYS) <= set(prod)
        assert 0 < prod["flops_per_device"] < res["flops_per_device"]
        assert prod["collective_bytes_per_device"] > 0
        assert sum(prod["collective_counts"].values()) > 0
        assert prod["roofline"]["bound_s"] > 0
        assert prod["argument_bytes_per_rank"] > 0
        assert prod["memory_analysis"]["argument_size_in_bytes"] > 0
        assert prod["model_flops"] == res["roofline"]["model_flops"]
        cfg = get_config(arch, smoke=True)
        if cfg.d_ff:
            assert [s["proj"][1:] for s in prod["sched"]] == [
                [cfg.d_model, cfg.d_ff], [cfg.d_ff, cfg.d_model]]


def test_cli_writes_one_json_per_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    out = tmp_path / "dry"
    ops = tmp_path / "ops.json"
    dryrun.main(["--arch", "llama3.2-1b", "--mesh", "1", "--smoke",
                 "--out", str(out), "--save-ops", str(ops),
                 "--microbatches", "2"])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--both-meshes", "--smoke", "--out", str(out)])
    names = sorted(os.listdir(out))
    assert names == sorted(
        [f"llama3.2-1b__{s}__1card.json" for s in SMALL_SHAPES]
        + ["hubert-xlarge__decode_32k__1pod.json",
           "hubert-xlarge__decode_32k__2pod.json"])
    for name in names:
        res = json.loads((out / name).read_text())
        if res["status"] == "ok":
            assert set(res) == REF_KEYS, name
        else:
            assert res["status"].startswith("skip("), name
    table = json.loads(ops.read_text())
    assert table["aten.mm"]["flops"] > 0
    assert "xla_cost_analysis" not in json.loads(
        (out / names[-1]).read_text())
    # an existing cell is skipped, as the reference's CLI does
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--mesh",
                 "1", "--smoke", "--out", str(out)])
    assert sorted(os.listdir(out)) == names
