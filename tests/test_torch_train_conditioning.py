"""Why ``tests/test_torch_train_recurrent.py`` holds xlstm-1.3b's train
step at 1e-2: its fp32 gradient is ill-conditioned at the SMOKE init.

The reference alone: scaling each parameter by 1 ± 2**-23 (one fp32 ulp)
moves its own gradient by more than 1e-3 of the largest element for
xlstm-1.3b, and by less than 1e-4 for llama3.2-1b, whose step the port
holds at 1e-4.  Two packages that sum in different orders differ by
about such a perturbation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as ref_get_config
from repro.dist.context import ParallelCtx as RefCtx
from repro.models import model as ref_model
from repro.train.data import SyntheticData as RefData
from test_torch_train import BATCH, SEQ


@pytest.mark.parametrize("arch,moves", [("xlstm-1.3b", True),
                                        ("llama3.2-1b", False)])
def test_reference_gradient_under_a_one_ulp_perturbation(arch, moves):
    """The reference's fp32 gradient on the train tests' batch before and
    after a one-ulp nudge of every parameter: the largest change as a
    share of the gradient's largest element."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    params = ref_model.init_model(jax.random.PRNGKey(0), rcfg, RefCtx(None))
    batch = jax.tree.map(jnp.asarray,
                         RefData(rcfg, BATCH, SEQ, seed=1).batch_at(0))
    grad = jax.jit(jax.grad(lambda p: ref_model.loss_fn(
        p, batch, rcfg, RefCtx(None))[0]))
    rng = np.random.default_rng(0)
    nudged = jax.tree.map(lambda a: a * (1 + 2.0 ** -23 * jnp.asarray(
        rng.choice([-1.0, 1.0], size=a.shape), jnp.float32)), params)
    shift = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max() / jnp.abs(a).max()),
        grad(params), grad(nudged))))
    assert (shift > 1e-3) if moves else (shift < 1e-4), shift
