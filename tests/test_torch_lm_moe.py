"""The port's mixture of experts (``repro_torch.lm.moe``) against the JAX
package's, in float32 within 1e-4.

Weights come from the reference's ``moe_init`` and are copied into the
port's module; inputs are made with numpy from a seed.  The routes (expert
ids, and under capacity pressure the kept set) must be equal exactly:

* ``no_drop`` (the capacity of a decode step), softmax router, top-2;
* capacity pressure: identical tokens at ``capacity_factor=0.5``, so most
  assignments of the one chosen expert pair are dropped;
* the sigmoid router with a shared expert (llama4's reduced shapes);
* router scores with exact ties, negative ones among them: the expert ids
  of ``jax.lax.top_k`` (the lowest index first);
* the port's ``MoEOpts`` refuses the reference's ``dispatch`` (its
  ``grouped_a2a`` is ``global_sort`` on one device), and ``moe_ffn``, the
  serving path's call, gives ``moe_apply``'s ``y`` bit for bit.

The combine sums each token's contributions in ascending slot order with
no atomics; a Python loop in that order gives the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402
from repro_torch.lm import moe  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4
D, FF = 32, 48

# name: (E, k, router, shared_ff, capacity_factor, no_drop, identical)
CASES = {
    "no_drop": (8, 2, "softmax", 0, 1.25, True, False),
    "capacity": (8, 2, "softmax", 0, 0.5, False, True),
    "sigmoid_shared": (4, 1, "sigmoid", 48, 4.0, False, False),
    "dropping": (8, 2, "softmax", 0, 1.0, False, False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def pair(n_experts, shared_ff, kind="swiglu", seed=0):
    """(reference params, port module) with the same weights."""
    params, _ = jmoe.moe_init(jax.random.PRNGKey(seed), D, FF, n_experts,
                              kind=kind, shared_ff=shared_ff)
    module, _ = moe.moe_init(torch.Generator(), D, FF, n_experts, kind=kind,
                             shared_ff=shared_ff)
    convert._load(module, jax.tree.map(np.asarray, params), "p", set())
    return params, module


def tokens(identical, b=3, s=10, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    if identical:
        x[:] = x[0, 0]
    return x


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_the_reference(case):
    n_experts, k, router, shared_ff, cf, no_drop, identical = CASES[case]
    params, module = pair(n_experts, shared_ff)
    x = tokens(identical)
    kw = dict(n_experts=n_experts, top_k=k, capacity_factor=cf,
              router_act=router, shared=shared_ff > 0, no_drop=no_drop)
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), **kw)
    y, aux = moe.moe_apply(module, torch.from_numpy(x), **kw)
    close(y, jy)
    for key in ("aux_lb", "aux_z"):
        close(aux[key], jaux[key])
    assert float(aux["frac_dropped"]) == float(jaux["frac_dropped"])
    if case == "capacity":
        assert float(aux["frac_dropped"]) > 0.5

    # The routes and the kept set, exactly.
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, D) @ np.asarray(params["router"]["w"])
    jg, je, jp = jmoe._route(jnp.asarray(logits), k, router)
    g, e, p = moe._route(torch.from_numpy(logits), k, router)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    close(g, jg)
    close(p, jp)
    cap = t * k if no_drop else int(np.ceil(t * k * cf / n_experts))
    want = jmoe._sort_dispatch(je.reshape(-1), t, k, n_experts, cap)
    got = moe._sort_dispatch(e.reshape(-1), t, k, n_experts, cap)
    for name, a, b in zip(("order", "se", "slot", "keep"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_top_k_ties_go_to_the_lowest_expert():
    """Exact ties among negative, zero and positive scores: the values
    and ids of ``jax.lax.top_k``, and the routes built on them."""
    rng = np.random.default_rng(2)
    scores = rng.choice(np.array([-2.5, -1.0, -0.25, 0.0, 0.5, 3.0],
                                 np.float32), size=(64, 8))
    scores[0] = 1.0                       # a row of one value
    scores[1, :4] = scores[1, 4:] = -3.0  # negative ties
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        v, i = moe.lax_top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    for router in ("softmax", "sigmoid"):
        _, je, _ = jmoe._route(jnp.asarray(scores), 2, router)
        _, e, _ = moe._route(torch.from_numpy(scores), 2, router)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_grouped_dispatch_is_refused():
    """The reference's ``grouped_a2a`` dispatch only differs from
    ``global_sort`` over several devices: the port's ``MoEOpts`` and
    ``moe_apply`` refuse the option, and ``moe_ffn`` (no aux) gives
    ``moe_apply``'s ``y`` bit for bit, dropping and not."""
    with pytest.raises(TypeError, match="dispatch"):
        M.MoEOpts(num_experts=8, top_k=2, d_ff_expert=64,
                  dispatch="grouped_a2a")
    _, module = pair(8, 0)
    x = torch.from_numpy(tokens(False))
    kw = dict(n_experts=8, top_k=2, capacity_factor=1.0)
    with pytest.raises(TypeError, match="dispatch"):
        moe.moe_apply(module, x, dispatch="grouped_a2a", **kw)
    for no_drop in (False, True):
        want, _ = moe.moe_apply(module, x, no_drop=no_drop, **kw)
        assert torch.equal(moe.moe_ffn(module, x, no_drop=no_drop, **kw),
                           want)


def test_combine_sums_in_slot_order():
    """Each token's kept contributions, added one by one to a zero row in
    ascending slot order (the reference's scatter-add order on the CPU),
    give the port's bits, for dropping and no-drop dispatch."""
    _, module = pair(8, 0, kind="relu2")
    x = torch.from_numpy(tokens(False, b=2, s=16, seed=3))
    t, k, n_experts = 32, 2, 8
    xf = x.reshape(t, D)
    for no_drop in (False, True):
        y, _ = moe.moe_apply(module, x, n_experts=n_experts, top_k=k,
                             kind="relu2", capacity_factor=0.75,
                             no_drop=no_drop)
        gate, eidx, _ = moe._route(moe.dense(module.router, xf), k,
                                   "softmax")
        cap = t * k if no_drop else int(np.ceil(t * k * 0.75 / n_experts))
        order, _, slot, keep = moe._sort_dispatch(eidx.reshape(-1), t, k,
                                                  n_experts, cap)
        stok = torch.arange(t).repeat_interleave(k)[order]
        sg = gate.reshape(-1)[order]
        buf = torch.full((n_experts * cap,), t)
        buf[slot[keep]] = stok[keep]
        xb = torch.cat([xf, torch.zeros((1, D))])[buf]
        yb = moe._expert_ffn(module, xb.reshape(n_experts, cap, D), "relu2")
        yb = yb.reshape(n_experts * cap, D)
        want = torch.zeros((t, D))
        for j in sorted(range(t * k), key=lambda j: int(slot[j])):
            if keep[j]:
                tok = int(stok[j])
                want[tok] = want[tok] + yb[slot[j]] * sg[j]
        assert int(keep.sum()) < t * k or no_drop
        assert torch.equal(y.reshape(t, D), want), no_drop
