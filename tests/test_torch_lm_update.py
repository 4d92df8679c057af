"""The port's AdamW update and microbatched train step against the JAX
package's, on the ten reduced configs, on the CPU.

The port's ``optimizer.update`` fed the reference's gradients gives the
reference's ``update`` within 1e-6 (``weight_decay=0.1``), with the
stacked-rank decay rule asserted: a layer's 1-D leaf (stacked, rank 2 in
the reference) is decayed, ``lnf/g`` and a shared block's gains are not.
One train step at ``microbatch=2`` gives the reference's
``make_train_step(..., microbatch=2)`` first moments (``0.1 x`` the clipped
gradient) within 1e-4 relative L2 per leaf, and its loss and aux.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import steps as jsteps  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402
from repro_torch.lm import steps  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from test_torch_lm_steps import (ARCHS, TOL, batch_of, flat,  # noqa: E402
                                 hold_tree, pair)

jax.config.update("jax_platform_name", "cpu")

OPT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_grads(jcfg, params, seed=3):
    """Gradient-like trees drawn with numpy, of the parameters' shapes."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.01), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_matches_reference(arch):
    """Fed the reference's gradients (two steps, so the moments are not
    zero), the port's ``update`` with ``decay_names`` gives the
    reference's parameters and moments within 1e-6, weight decay 0.1."""
    jcfg, params, cfg, model = pair(arch)
    opt_cfg = dict(lr=1e-2, warmup=0, total_steps=10, weight_decay=0.1)
    jstate = jopt.init(params)
    tparams = steps.param_dict(model)
    state = opt_lib.init(tparams)
    decay = steps.decay_names(cfg, model)
    layout = steps._layout(cfg, model)
    for i in range(2):
        jg = ref_grads(jcfg, params, seed=3 + i)
        grads = {}
        for path, leaf in flat(jg).items():
            for r, name in enumerate(layout[path]):
                arr = leaf[r] if path[0] in M.STACKS else leaf
                grads[name] = torch.from_numpy(np.array(arr))
        params, jstate, jm = jax.jit(jopt.update, static_argnums=0)(
            jopt.OptConfig(**opt_cfg), jg, jstate, params)
        _, state, m = opt_lib.update(opt_lib.OptConfig(**opt_cfg), grads,
                                     state, tparams, decay=decay)
    hold_tree(cfg, model, tparams, params, OPT_TOL, rel=False)
    hold_tree(cfg, model, state["m"], jstate["m"], OPT_TOL, rel=False)
    hold_tree(cfg, model, state["v"], jstate["v"], OPT_TOL, rel=False)
    assert state["step"] == int(jstate["step"]) == 2
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    # The reference decays by the stacked rank: a layer's 1-D norm gain
    # is decayed, the final norm's is not.
    pos = f"b0_{cfg.pattern[0]}"
    assert set(layout[("scan", pos, "ln1", "g")]) <= decay
    assert not set(layout[("lnf", "g")]) & decay
    assert all(n in decay for path, names in layout.items()
               if path[0] in M.STACKS for n in names)
    for path, names in layout.items():     # zamba2's shared block
        if path[0] == "shared" and path[-1] == "g":
            assert not set(names) & decay, path


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_step_matches_reference(arch):
    jcfg, params, cfg, model = pair(arch)
    jb, tb = batch_of(cfg, b=4)
    opt_cfg = dict(lr=1e-3, warmup=0, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptConfig(**opt_cfg),
                                           microbatch=2))
    _, jstate, jm = jstep(params, jopt.init(params), jb)
    step = steps.make_train_step(model, cfg, opt_lib.OptConfig(**opt_cfg),
                                 microbatch=2)
    tparams = steps.param_dict(model)
    _, state, m = step(tparams, opt_lib.init(tparams), tb)
    hold_tree(cfg, model, state["m"], jstate["m"], TOL)
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
