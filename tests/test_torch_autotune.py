"""The kernel autotune cache: the port's ``kernels.autotune`` against the
reference's ``repro.kernels.autotune``.

Bucket keys must be equal for the same shape and dtype (bf16 included,
named as the reference names it), a cache file saved by either package
must load in the other with the same fingerprint, ``preferred_tile`` must
pick the same tile, an empty or disabled cache must leave the product
bitwise as it is without the cache, and a recorded winner must steer
``core.summa._local_dot``.  A table records the kind of device that
measured it, and a product on another kind refuses it.  Timing runs on
the CPU here, through the kernels' plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_at
from repro_torch.core import DistributedMatmul, Grid
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def clean_autotune():
    """Both packages' process singletons start and end empty."""
    at.set_autotune_cache(None)
    ref_at.set_autotune_cache(None)
    yield
    at.set_autotune_cache(None)
    ref_at.set_autotune_cache(None)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("shape", [(1, 1, 1), (48, 60, 33), (256, 256, 256),
                                   (32768, 256, 32768), (300, 9000, 5)])
@pytest.mark.parametrize("rank", [0, 3, 64, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bucket_keys_match_reference(shape, rank, dtype):
    torch_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}[dtype]
    want = ref_at.bucket_key(*shape, rank=rank, dtype=getattr(jnp, dtype))
    assert at.bucket_key(*shape, rank=rank, dtype=torch_dtype) == want
    assert at.bucket_key(*shape, rank=rank, dtype=dtype) == want
    assert at._key_str(want) == ref_at._key_str(want)
    assert at._key_parse(at._key_str(want)) == want


def _entry(winner, t, tiles=None):
    return {"winner": winner, "times_s": {winner: t, "xla": 2 * t},
            "tiles": tiles}


def test_cache_files_carry_across_packages(tmp_path):
    port = at.KernelAutotuner(device_kind="cpu")
    port.table[at.bucket_key(128, 128, 128)] = _entry("pallas", 1e-5,
                                                      [128, 128, 128])
    port.table[at.bucket_key(256, 256, 256, dtype=torch.bfloat16)] = _entry(
        "xla", 3e-5)
    port.table[at.bucket_key(64, 64, 64, rank=8)] = _entry("factored", 1e-6)
    path = tmp_path / "port.json"
    port.save(str(path))
    ref = ref_at.KernelAutotuner()
    assert ref.load(str(path)) == 3
    assert ref.fingerprint() == port.fingerprint() != ""
    assert ref.lookup(128, 128, 128) == port.lookup(128, 128, 128)
    assert ref.winner(200, 200, 200, dtype=jnp.bfloat16) == "xla"
    # and back: a file the reference tuned and saved
    ref2 = ref_at.KernelAutotuner()
    ref2.tune(48, 48, 48, repeats=1, routes=("xla",))
    ref_path = tmp_path / "ref.json"
    ref2.save(str(ref_path))
    back = at.KernelAutotuner()
    assert back.load(str(ref_path)) == 1
    assert back.fingerprint() == ref2.fingerprint()
    assert back.winner(60, 50, 33) == "xla"
    # the reference's file records no device: a product refuses it until
    # its loader vouches for the kind
    assert back.device_kind is None
    with pytest.raises(ValueError, match="unrecorded device"):
        back.winner(60, 50, 33, device="cpu")
    vouched = at.KernelAutotuner()
    assert vouched.load(str(ref_path), device_kind="cpu") == 1
    assert vouched.winner(60, 50, 33, device="cpu") == "xla"
    # merge=False replaces; the file is the persisted truth on collisions
    assert port.load(str(ref_path), merge=False) == 1
    assert list(port.table) == list(back.table)


def test_tune_times_every_route_and_persists(tmp_path, monkeypatch):
    t = at.KernelAutotuner()
    entry = t.tune(48, 48, 48, rank=4, repeats=1, device="cpu")
    assert set(entry["times_s"]) == {"xla", "pallas", "bsmm", "grouped",
                                     "factored"}
    assert entry["times_s"][entry["winner"]] == min(entry["times_s"].values())
    assert entry["tiles"] == [64, 64, 64]
    assert t.device_kind == "cpu"
    assert t.lookup(60, 50, 33, rank=7, device="cpu") is entry
    assert t.lookup(200, 200, 200) is None
    path = tmp_path / "autotune.json"
    t.save(str(path))
    r = at.KernelAutotuner()
    assert r.load(str(path)) == 1
    assert r.fingerprint() == t.fingerprint() != ""
    assert r.device_kind == "cpu" and r.table == t.table
    # the process singleton seeds itself from REPRO_AUTOTUNE_CACHE
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert at.cache_fingerprint() == t.fingerprint()
    assert at.autotune_cache().winner(48, 48, 48, rank=4,
                                      device="cpu") == entry["winner"]


def _foreign_file(tmp_path):
    """A cache file measured on another kind of device."""
    foreign = at.KernelAutotuner(device_kind="TPU v5 lite")
    foreign.table[at.bucket_key(64, 16, 64)] = _entry("xla", 1e-6)
    path = tmp_path / "foreign.json"
    foreign.save(str(path))
    return path


def test_cache_from_another_device_is_refused(tmp_path, monkeypatch):
    """Winners measured on another kind of device never steer a product
    here: the consult raises, and so do merging and tuning into them.
    The reference still reads the file."""
    path = _foreign_file(tmp_path)
    assert ref_at.KernelAutotuner().load(str(path)) == 1
    loaded = at.KernelAutotuner()
    assert loaded.load(str(path)) == 1
    assert loaded.device_kind == "TPU v5 lite"
    assert loaded.winner(64, 16, 64) == "xla"  # no device named: no check
    with pytest.raises(ValueError, match="measured on TPU v5 lite"):
        loaded.lookup(64, 16, 64, device="cpu")
    with pytest.raises(ValueError, match="measured on TPU v5 lite"):
        at.KernelAutotuner().load(str(path), device_kind="cpu")
    with pytest.raises(ValueError, match="do not mix"):
        loaded.tune(32, 32, 32, repeats=1, device="cpu", routes=("xla",))
    local = at.KernelAutotuner()
    local.tune(32, 32, 32, repeats=1, device="cpu", routes=("xla",))
    with pytest.raises(ValueError, match="do not mix"):
        local.load(str(path))
    assert local.load(str(path), merge=False) == 1  # replaces: one kind
    # named by the environment, the file reaches no product on the CPU
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    mm, a, b = _product("pallas")
    with pytest.raises(ValueError, match="measured on TPU v5 lite"):
        mm(a, b)
    with pytest.raises(ValueError, match="measured on TPU v5 lite"):
        at.preferred_tile(300, device="cpu")


def test_tune_skips_refused_routes_and_raises_on_faults(monkeypatch):
    """A route whose wrapper refuses the shape (``ValueError``) is skipped;
    any other error — a kernel that fails to build or launch — propagates."""
    def refuse(*args, **kwargs):
        raise ValueError("shape refused")

    def fault(*args, **kwargs):
        raise RuntimeError("CUDA error")

    monkeypatch.setattr(ops, "grouped_gemm", refuse)
    entry = at.KernelAutotuner().tune(32, 32, 32, repeats=1, device="cpu")
    assert "grouped" not in entry["times_s"] and "xla" in entry["times_s"]
    monkeypatch.setattr(ops, "bsmm", fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        at.KernelAutotuner().tune(32, 32, 32, repeats=1, device="cpu")
    with pytest.raises(ValueError, match="no route"):
        at.KernelAutotuner().tune(32, 32, 32, repeats=1, device="cpu",
                                  routes=("grouped",))


def _product(local_matmul, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32))
    mm = DistributedMatmul(Grid.local("cpu"), strategy="taskbased",
                           k_blocks=4, local_matmul=local_matmul)
    return mm, a, b


@pytest.mark.parametrize("local_matmul", ["xla", "pallas"])
def test_disabled_and_empty_caches_are_bitwise_off(monkeypatch,
                                                   local_matmul):
    mm, a, b = _product(local_matmul)
    assert at.cache_fingerprint() == ""
    cold = mm(a, b)
    # a cache with entries for other buckets only changes nothing
    other = at.KernelAutotuner(device_kind="cpu")
    other.table[at.bucket_key(4096, 4096, 4096)] = _entry("pallas", 1e-3)
    at.set_autotune_cache(other)
    assert torch.equal(mm(a, b), cold)
    # a steering entry, disabled by the environment: off
    plan = mm.plan(64, 64, 64)
    steer = at.KernelAutotuner(device_kind="cpu")
    flip = "xla" if local_matmul == "pallas" else "pallas"
    steer.table[at.bucket_key(64, plan.kb_width, 64)] = _entry(flip, 1e-6)
    at.set_autotune_cache(steer)
    assert at.cache_fingerprint() == steer.fingerprint() != ""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert steer.lookup(64, plan.kb_width, 64, device="cpu") is None
    assert at.cache_fingerprint() == ""
    assert ref_at.cache_fingerprint() == ""
    assert torch.equal(mm(a, b), cold)


@pytest.mark.parametrize("winner", ["pallas", "xla"])
def test_winner_steers_local_dot(monkeypatch, winner):
    """A cached winner reroutes each panel product, with the same numbers
    within the fp32 tolerance; the reference reroutes the same way."""
    policy = "xla" if winner == "pallas" else "pallas"
    mm, a, b = _product(policy)
    cold = mm(a, b)
    plan = mm.plan(64, 64, 64)
    key = (64, plan.kb_width, 64)
    port_warm, ref_warm = (at.KernelAutotuner(device_kind="cpu"),
                           ref_at.KernelAutotuner())
    port_warm.table[at.bucket_key(*key)] = _entry(winner, 1e-6, [32, 16, 32])
    ref_warm.table[ref_at.bucket_key(*key)] = _entry(winner, 1e-6,
                                                     [32, 16, 32])
    at.set_autotune_cache(port_warm)
    ref_at.set_autotune_cache(ref_warm)
    spy = _Spy(ops.tiled_matmul_plain)
    monkeypatch.setattr(ops, "tiled_matmul_plain", spy)
    hot = mm(a, b)
    assert spy.calls == (plan.k_steps if winner == "pallas" else 0)
    np.testing.assert_allclose(hot.numpy(), cold.numpy(), atol=1e-4,
                               rtol=1e-5)
    assert ref_at.autotune_cache().winner(*key) == (
        at.autotune_cache().winner(*key)) == winner


@pytest.mark.parametrize("table", [
    {}, {128: 1e-4}, {128: 1e-4, 256: 5e-4}, {128: 1e-3, 256: 1e-4,
                                             512: 2e-3},
], ids=["cold", "128", "128-256", "all"])
@pytest.mark.parametrize("max_block", [100, 200, 300, 700])
def test_preferred_tile_matches_reference(table, max_block):
    port, ref = at.KernelAutotuner(device_kind="cpu"), ref_at.KernelAutotuner()
    for c, t in table.items():
        port.table[at.bucket_key(c, c, c)] = _entry("xla", t)
        ref.table[ref_at.bucket_key(c, c, c)] = _entry("xla", t)
    at.set_autotune_cache(port)
    ref_at.set_autotune_cache(ref)
    assert at.preferred_tile(max_block, device="cpu") == (
        ref_at.preferred_tile(max_block))
    assert at.preferred_tile(max_block, dtype=torch.bfloat16) is None
