"""The serving entry point (``launch/serve.py``), its grids (``launch/mesh.py``)
and the parameter specs (``dist/partitioning.py``) against the JAX
package.

``param_specs`` of the port's ``LM`` must equal the reference's
``PartitionSpec`` of the same leaf for all ten archs (the reference's
stacked unit leaves lose their leading scan entry, which is always
replicated); ``param_shardings`` on a grid whose axes divide no width
must fall back exactly as the reference's ``_validate_spec`` does, and
``launch.serve`` reports the bytes a rank would hold under them.  The
entry point runs on the CPU at SMOKE size (``--device cpu --smoke``) in its
fixed, ``--continuous`` and ``--paged`` modes, and its tokens must equal
a direct drive of the port's engine.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.dist import partitioning as ref_part
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import model as ref_model
from repro_torch.configs.registry import get_config
from repro_torch.core import Grid
from repro_torch.dist import partitioning as part
from repro_torch.dist.context import ParallelCtx
from repro_torch.launch import mesh
from repro_torch.launch import serve
from repro_torch.models.model import LM, init_model
from repro_torch.serve import engine
from repro_torch.serve import plan_service as ps
from repro_torch.serve.scheduler import ragged_trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_plan_service(monkeypatch):
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    ps.set_plan_service(None)
    yield
    ps.set_plan_service(None)


class _Shape:
    """A stand-in mesh for the reference's ``_validate_spec``: only its
    ``.shape`` mapping is read."""

    def __init__(self, shape):
        self.shape = shape


def _reference_specs(arch):
    """The reference's spec of every leaf by the port's parameter name,
    with each stacked unit leaf's scan entry dropped, and the leaves'
    shapes."""
    rcfg = ref_get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda: ref_model.init_model(
        jax.random.PRNGKey(0), rcfg, RefCtx(None)))
    specs = ref_part.param_specs(shapes)
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        keys = [str(getattr(e, "key", getattr(e, "idx", e))) for e in path]
        leaf = shapes
        for e in path:
            leaf = leaf[getattr(e, "key", getattr(e, "idx", None))]
        spec, shape = tuple(spec), tuple(leaf.shape)
        if keys[0] == "units":
            assert spec[0] is None, (keys, spec)  # the scan axis
            for i in range(rcfg.units):
                out[".".join(["units", str(i)] + keys[1:])] = (spec[1:],
                                                               shape[1:])
        else:
            out[".".join(keys)] = (spec, shape)
    return out


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_param_specs_match_reference(arch):
    assert len(REF_ARCH_IDS) == 10
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, device="meta")
    want = _reference_specs(arch)
    got = part.param_specs(model)
    assert set(got) == set(want)
    for name, (spec, shape) in want.items():
        assert got[name] == spec, name
    # the fallback to replicated where a width does not divide its axes,
    # and the bytes a rank would hold under the specs (launch.serve's line)
    params = dict(model.named_parameters())
    for sizes in ((2, 3), (4, 1), (1, 1)):
        grid = Grid(sizes=sizes)
        fake = _Shape(grid.shape)
        got = part.param_shardings(
            {n: p.shape for n, p in params.items()}, grid)
        whole = shard = 0
        for name, (spec, shape) in want.items():
            ref = ref_part._validate_spec(jax.sharding.PartitionSpec(*spec),
                                          shape, fake)
            assert got[name] == tuple(ref), (name, sizes)
            n = math.prod(shape) * params[name].element_size()
            whole += n
            for entry in ref:
                for axis in (entry if isinstance(entry, tuple) else (entry,)):
                    n //= fake.shape[axis] if axis is not None else 1
            shard += n
        assert serve.param_bytes(model, grid) == (whole, shard), sizes


def test_validate_spec_refusals():
    grid = Grid(sizes=(2, 2))
    with pytest.raises(ValueError, match="over-sharded"):
        part._validate_spec(("data", "model", None), (4, 4), grid)
    with pytest.raises(ValueError, match="unknown grid axis"):
        part._validate_spec(("pod",), (4,), grid)
    assert part._validate_spec((("data", "model"), None), (8, 3), grid) == (
        ("data", "model"), None)
    assert part._validate_spec((("data", "model"),), (6,), grid) == (None,)


def test_grids():
    g = mesh.make_host_grid(device="cpu")
    assert g.shape == {"data": 1, "model": 1} and g.device.type == "cpu"
    g3 = mesh.make_grid((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert g3.axis_names == ("pod", "data", "model")
    with pytest.raises(RuntimeError, match="not initialised"):
        mesh.make_host_grid(2, 2, device="cpu")
    # the collectives decode attention combines with: the identity on an
    # axis of one rank, for both reductions; an unknown one is refused
    x = torch.arange(4.0)
    assert g.all_reduce(x, "model", op="max") is x
    assert g.all_reduce(x, ("data", "model")) is x
    with pytest.raises(ValueError, match="op="):
        g.all_reduce(x, "model", op="min")


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

ARGS = ["--device", "cpu", "--smoke", "--batch", "2", "--prompt-len", "12",
        "--gen", "5"]


def _model(arch="llama3.2-1b"):
    cfg = get_config(arch, smoke=True)
    return cfg, init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b",
                                  "qwen2-vl-72b"])
def test_fixed_batch_equals_the_engine(arch, capsys):
    tokens = serve.main(ARGS + ["--arch", arch])
    out = capsys.readouterr().out
    assert "generated shape: (2, 5)" in out and "prefill:" in out
    cfg, model = _model(arch)
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    # on one rank the specs shard nothing
    assert f"params: {whole:,} bytes whole; {whole:,} held by a rank" in out
    ctx = ParallelCtx(None)
    with torch.inference_mode():
        logits, cache = engine.prefill(
            model, serve.prompt_inputs(cfg, 2, 12, "cpu"), cfg, ctx,
            max_len=17)
        want = [logits.argmax(-1)]
        for _ in range(4):
            logits, cache = engine.decode_step(model, cache, want[-1], cfg,
                                               ctx)
            want.append(logits.argmax(-1))
    np.testing.assert_array_equal(tokens, torch.stack(want, 1).numpy())


@pytest.mark.parametrize("paged", [False, True])
def test_continuous_equals_per_request_engine(paged):
    """The scheduler's outputs over ``launch.serve``'s ragged trace equal each
    request served alone through the engine."""
    res = serve.main(ARGS + ["--continuous"] + (["--paged"] if paged else []))
    assert res["backend"] == ("paged" if paged else "dense")
    assert res["requests"] == 8
    cfg, model = _model()
    ctx = ParallelCtx(None)
    with torch.inference_mode():
        for r in ragged_trace(8, prompt_lens=(6, 12), gen_lens=(1, 5),
                              vocab=cfg.vocab_size, seed=0):
            logits, cache = engine.prefill(
                model, {"tokens": torch.from_numpy(
                    r.prompt.astype(np.int64))[None]}, cfg, ctx, max_len=17)
            toks = [int(logits[0].argmax())]
            for _ in range(r.max_new_tokens - 1):
                logits, cache = engine.decode_step(
                    model, cache, torch.tensor([toks[-1]]), cfg, ctx)
                toks.append(int(logits[0].argmax()))
            assert res["outputs"][r.rid] == toks, r.rid


def test_plan_cache_warm_restart(tmp_path, capsys):
    """``--matmul-strategy auto --plan-cache``: the first run tunes every
    shape and saves; a second (fresh singleton) re-applies them all with
    zero tunes — and the tokens are the summa engine's."""
    path = str(tmp_path / "plans.json")
    argv = ARGS + ["--matmul-strategy", "auto", "--plan-cache", path]
    first = serve.main(argv)
    assert "tunes=4 hits=0" in capsys.readouterr().out
    ps.set_plan_service(None)
    second = serve.main(argv)
    out = capsys.readouterr().out
    assert "loaded 4 winners" in out and "tunes=0 hits=4" in out
    np.testing.assert_array_equal(first, second)


def test_refusals():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(ARGS + ["--arch", "hubert-xlarge"])
    with pytest.raises(engine.CacheCapacityError, match="raise --max-len"):
        serve.main(ARGS + ["--max-len", "10"])
    # a windowed arch wraps its ring: no capacity limit
    assert get_config("mixtral-8x7b", smoke=True).window is not None
    assert serve.main(ARGS + ["--arch", "mixtral-8x7b", "--max-len",
                              "10"]).shape == (2, 5)
