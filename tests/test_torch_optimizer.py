"""The training substrate against the JAX package: optimizers, data and
checkpoints.

Optimizers: AdamW and Adafactor take 5 updates on the reference's
parameter trees of llama3.2-1b and mixtral-8x7b (SMOKE, fp32; the units'
leaves stacked, as the port's train step hands them over), with gradients
drawn from a numpy seed, against the reference's ``opt.update``: new
params and every state slot within fp32 rtol 1e-6.  The unit norm scales
(``(U, d)`` leaves) are included, and a control shows that rules applied
per unstacked tensor would miss them.  ``_schedule`` for every step from
0 to ``total_steps``.

Data: ``batch_at`` bitwise equal to the reference's for the dense, audio
and vision-language families; ``Prefetcher`` resuming at a step.

Checkpoints: the manifest of one converted train state written by both
packages is equal (paths, files, shapes, dtypes, sha256 digests); each
package restores the other's; a leftover ``.tmp`` is never the latest, a
corrupted leaf raises ``IOError``, and ``CheckpointManager`` keeps the
last ``keep``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import model as ref_model
from repro.train import checkpoint as ref_ck
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.data import Prefetcher as RefPrefetcher
from repro.train.data import SyntheticData as RefData
from repro_torch.configs.registry import get_config
from repro_torch.dist.context import ParallelCtx
from repro_torch.models.convert import train_state_from_reference
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts
from repro_torch.train.data import Prefetcher, SyntheticData
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.tree import leaves, tree_map

STEPS = 5


def _ref_params(arch):
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    return ref_model.init_model(jax.random.PRNGKey(0), rcfg, RefCtx(None))


def _torch_tree(np_tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), np_tree)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)


def _run_both(arch, name, cut=None):
    """5 updates in each package; returns the port's and the reference's
    (params, state) as flat path -> array dicts.  ``cut`` maps the port's
    trees before each update (the per-tensor control)."""
    cfg = OptimizerConfig(name=name, peak_lr=1e-2, warmup_steps=2,
                          total_steps=STEPS)
    ropt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(
        **dataclasses.asdict(cfg)))
    opt = make_optimizer(cfg)
    rparams = _ref_params(arch)
    rstate = ropt.init(rparams)
    params = _torch_tree(jax.tree.map(np.asarray, rparams))
    fwd, back = cut or (lambda t: t, lambda t: t)
    state = opt.init(fwd(params))
    for step in range(STEPS):
        g = _grads(rparams, step)
        rparams, rstate = ropt.update(jax.tree.map(jnp.asarray, g), rstate,
                                      rparams, jnp.int32(step))
        params, state = opt.update(fwd(_torch_tree(g)), state, fwd(params),
                                   torch.tensor(step, dtype=torch.int32))
        params = back(params)
    got = {f"params/{k}": v.numpy() for k, v in leaves(params)}
    got.update({f"opt/{k}": v.numpy() for k, v in leaves(back(state))})
    want = {f"params/{k}": np.asarray(v) for k, v in leaves(
        jax.tree.map(np.asarray, rparams))}
    want.update({f"opt/{k}": np.asarray(v) for k, v in leaves(
        jax.tree.map(np.asarray, rstate))})
    return got, want


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(arch, name):
    got, want = _run_both(arch, name)
    assert set(got) == set(want)
    assert any("units/b0/attn/norm/scale" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def _unstack_units(tree):
    """The per-tensor control: each stacked unit leaf split into U
    separate leaves (``units/<i>/...``), as rules applied to the port's
    unstacked ``LM`` parameters would see them."""
    if "units" not in tree:
        return {k: _unstack_units(v) if isinstance(v, dict) else v
                for k, v in tree.items()}
    u = next(v for _, v in leaves(tree["units"])).shape[0]
    return {**tree, "units": [tree_map(lambda a, i=i: a[i], tree["units"])
                              for i in range(u)]}


def _restack_units(tree):
    if isinstance(tree, dict) and isinstance(tree.get("units"), list):
        units = tree["units"]
        return {**tree, "units": tree_map(lambda *a: torch.stack(a),
                                          units[0], *units[1:])}
    if isinstance(tree, dict):
        return {k: _restack_units(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_per_tensor_rules_would_miss_the_unit_norm_scales(name):
    """Applied per unstacked unit tensor, a norm scale ``(d,)`` is neither
    weight-decayed (AdamW) nor factored (Adafactor): the result leaves the
    reference's, which the stacked update above holds to 1e-6."""
    got, want = _run_both("llama3.2-1b", name,
                          cut=(_unstack_units, _restack_units))
    k = "params/units/b0/attn/norm/scale"
    assert not np.allclose(got[k], want[k], rtol=1e-4, atol=0)


def test_schedule_matches_reference():
    cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=7, total_steps=50)
    rcfg = ref_opt.OptimizerConfig(**dataclasses.asdict(cfg))
    for step in range(cfg.total_steps + 1):
        got = float(opt_mod._schedule(cfg, torch.tensor(step,
                                                        dtype=torch.int32)))
        want = float(ref_opt._schedule(rcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), step


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    opt = make_optimizer(OptimizerConfig(name=name, peak_lr=0.1,
                                         warmup_steps=1, total_steps=100,
                                         weight_decay=0.0))
    params = {"w": torch.tensor([[3.0, -2.0], [1.0, 4.0]])}
    state = opt.init(params)
    l0 = float((params["w"] ** 2).sum())
    for step in range(50):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params, torch.tensor(step))
    assert float((params["w"] ** 2).sum()) < 0.1 * l0


def test_adafactor_state_is_factored():
    opt = make_optimizer(OptimizerConfig(name="adafactor"))
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros((64,))}
    state = opt.init(params)
    assert state["v"]["w"]["vr"].shape == (64,)
    assert state["v"]["w"]["vc"].shape == (32,)
    assert state["v"]["b"]["v"].shape == (64,)
    assert sum(x.numel() for _, x in leaves(state)) < params["w"].numel()


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge",
                                  "qwen2-vl-72b"])
def test_batch_at_equals_reference(arch):
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    for step in (0, 5):
        got = SyntheticData(cfg, 4, 32, seed=3).batch_at(step)
        want = RefData(rcfg, 4, 32, seed=3).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prefetcher_resumes_at_a_step():
    cfg = get_config("llama3.2-1b", smoke=True)
    data = SyntheticData(cfg, batch=4, seq=32, seed=3)
    pre = Prefetcher(data, start_step=5)
    try:
        got = [pre.next() for _ in range(3)]
    finally:
        pre.stop()
    rpre = RefPrefetcher(RefData(ref_get_config("llama3.2-1b", smoke=True),
                                 batch=4, seq=32, seed=3), start_step=5)
    try:
        want = [rpre.next() for _ in range(3)]
    finally:
        rpre.stop()
    for (s, b), (rs, rb) in zip(got, want):
        assert s == rs
        np.testing.assert_array_equal(b["tokens"], rb["tokens"])
    toks = got[0][1]["tokens"]
    s = toks.shape[1]
    np.testing.assert_array_equal(toks[:, s // 2 + 1],
                                  (3 * toks[:, s // 2] + 7) % cfg.vocab_size)


# --------------------------------------------------------------- checkpoints


def _states(name, dtype="bfloat16"):
    """One train state of llama3.2-1b (SMOKE) in the reference, after one
    reference step, and the same converted into the port."""
    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              dtype=dtype)
    ocfg = dict(name=name, total_steps=10, warmup_steps=1)
    ropt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(**ocfg))
    rstate = ref_ts.make_train_state(jax.random.PRNGKey(0), rcfg,
                                     RefCtx(None), ropt)
    batch = RefData(rcfg, 2, 16, seed=0).batch_at(0)
    rstate, _ = jax.jit(ref_ts.build_train_step(rcfg, RefCtx(None), ropt))(
        rstate, jax.tree.map(jnp.asarray, batch))
    state = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       cfg, "cpu")
    return rstate, state, make_optimizer(OptimizerConfig(**ocfg)), cfg


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_checkpoints_are_cross_readable(tmp_path, name):
    rstate, state, opt, cfg = _states(name)
    a = ref_ck.save_checkpoint(str(tmp_path / "ref"), 1, rstate)
    b = ck.save_checkpoint(str(tmp_path / "port"), 1, ts.state_tree(state))
    assert _manifest(a) == _manifest(b)
    assert list(_manifest(a)["leaves"]) == list(_manifest(b)["leaves"])
    # the port restores the reference's checkpoint into a fresh state
    fresh = ts.abstract_train_state(cfg, ParallelCtx(None), opt)
    tree = ck.restore_checkpoint(str(tmp_path / "ref"), 1,
                                 ts.state_tree(fresh), device="cpu")
    got = {k: v.float().numpy() for k, v in leaves(tree)}
    want = {k: np.asarray(v, np.float32) for k, v in leaves(
        jax.tree.map(np.asarray, rstate))}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tree["step"].dtype == torch.int32
    # the reference restores the port's
    back = ref_ck.restore_checkpoint(str(tmp_path / "port"), 1, rstate)
    for (k, x), (_, y) in zip(leaves(jax.tree.map(np.asarray, back)),
                              leaves(jax.tree.map(np.asarray, rstate))):
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32), err_msg=k)


def test_checkpoint_checksum_atomicity_and_keep(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}
    ck.save_checkpoint(str(tmp_path), 5, tree)
    assert ck.latest_step(str(tmp_path)) == 5
    restored = ck.restore_checkpoint(str(tmp_path), 5, tree)
    for (_, x), (_, y) in zip(leaves(tree), leaves(restored)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)
    # a leftover .tmp from a crashed writer is never picked up
    os.makedirs(tmp_path / "step_9.tmp")
    assert ck.latest_step(str(tmp_path)) == 5
    # corruption detection
    base = tmp_path / "step_5"
    victim = next(f for f in sorted(os.listdir(base)) if f.endswith(".npy"))
    with open(base / victim, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        ck.restore_checkpoint(str(tmp_path), 5, tree)
    # a shape mismatch is refused
    with pytest.raises(ValueError):
        ck.restore_checkpoint(str(tmp_path), 5,
                              {**tree, "a": torch.zeros(4, 3)}, verify=False)
    # the manager keeps the last `keep` and saves every `every`
    mgr = ck.CheckpointManager(str(tmp_path / "m"), every=2, keep=2)
    saved = [mgr.maybe_save(s, lambda: tree) for s in range(1, 9)]
    assert saved == [False, True] * 4
    assert sorted(os.listdir(tmp_path / "m")) == ["step_6", "step_8"]
