"""The port's LM gradients (``repro_torch.lm.steps``, ``return_grads=True``)
against ``jax.grad`` of the JAX package's ``loss_fn``, on the ten reduced
configs and smollm with the embeddings frontend, on the CPU: within 1e-4
relative L2 per reference leaf, a stacked leaf rep by rep, every gradient
finite; the loss and aux the step reports within 1e-4.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import steps as jsteps  # noqa: E402
from repro_torch.lm import steps  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from test_torch_lm_steps import (CASES, IDS, TOL, batch_of,  # noqa: E402
                                 hold_tree, jax_side, pair)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_loss_grads(arch, overrides=()):
    """The reference's (ce, aux) and gradient of the total on
    ``batch_of``'s batch, under ``jit``."""
    jcfg, params = jax_side(arch, overrides)
    jb, _ = batch_of(jcfg)
    f = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, jb), has_aux=True))
    (_, (ce, aux)), grads = f(params)
    return float(ce), float(aux), grads


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_grads_match_reference(arch, over):
    _, _, cfg, model = pair(arch, over)
    _, tb = batch_of(cfg)
    jce, jaux, jgrads = jax_loss_grads(arch, over)
    step = steps.make_train_step(model, cfg, opt_lib.OptConfig())
    grads, metrics = step(steps.param_dict(model), None, tb,
                          return_grads=True)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    hold_tree(cfg, model, grads, jgrads, TOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jce),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jaux),
                               rtol=TOL, atol=TOL)
