"""The port's LM train step (``repro_torch.lm.steps``) against the JAX
package's, on the ten reduced configs (and smollm with the embeddings
frontend), on the CPU.

``loss_fn``'s total, cross entropy and MoE aux within 1e-4; two steps on
one batch lower the loss (``tests/test_lm_archs.py``'s check of the
reference).  ``test_torch_lm_grads.py`` holds the gradients,
``test_torch_lm_update.py`` AdamW and microbatching,
``test_torch_lm_train.py`` checkpoints, resume, the Mamba2 repair and the
launcher, with the helpers of this file.

Weights go JAX -> port through ``convert.lm_from_jax``; inputs are made
with numpy from a seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.lm import model as jmodel  # noqa: E402
from repro.lm import steps as jsteps  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402
from repro_torch.lm import steps  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4
B, S = 2, 16
ARCHS = sorted(configs.ARCHS)
# (arch, config overrides): the ten, and the embeddings frontend (no
# config uses it; smollm's reduced config takes it as an override).
CASES = [(a, ()) for a in ARCHS] + [("smollm-135m",
                                     (("frontend", "embeddings"),))]
IDS = ARCHS + ["smollm-135m-embeddings"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_side(arch, overrides=(), seed=0):
    """(JAX config, params); init under ``jit`` (seconds faster than op
    by op)."""
    jcfg = jconfigs.lm_reduced(arch, **dict(overrides))
    init = jax.jit(lambda key: jmodel.init(key, jcfg)[0])
    return jcfg, init(jax.random.PRNGKey(seed))


def jax_loss(arch, overrides=()):
    """The reference's (total, ce, aux) on ``batch_of``'s batch."""
    jcfg, params = jax_side(arch, overrides)
    jb, _ = batch_of(jcfg)
    tot, (ce, aux) = jax.jit(lambda p: jsteps.loss_fn(p, jcfg, jb))(params)
    return float(tot), float(ce), float(aux)


def pair(arch, overrides=(), seed=0):
    """(JAX config, params; port config, a new model) with the same
    weights."""
    jcfg, params = jax_side(arch, overrides, seed)
    cfg = configs.lm_reduced(arch, **dict(overrides))
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


def batch_of(cfg, b=B, s=S, seed=1):
    """(JAX batch, port batch): tokens, labels by the reference's rule
    ``(tokens * 7 + position) % vocab``, frames where the config reads
    them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out = {"labels": (toks * 7 + np.arange(s)[None, :]) % cfg.vocab}
    if cfg.encoder_layers or cfg.frontend == "embeddings":
        out["frames"] = (rng.standard_normal((b, s, cfg.d_model))
                         * 0.1).astype(np.float32)
        if cfg.encoder_layers:
            out["dec_tokens"] = toks
    else:
        out["tokens"] = toks
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()})


def flat(tree, path=()) -> dict:
    """{path tuple: numpy leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, sub in tree.items():
            out.update(flat(sub, path + (k,)))
        return out
    return {path: np.asarray(tree)}


def per_leaf(cfg, model, tensors: dict):
    """{reference path: [numpy array a rep]} of the port's ``{name:
    tensor}`` (one entry for a leaf that is not stacked)."""
    return {path: [tensors[n].detach().float().numpy() for n in names]
            for path, names in steps._layout(cfg, model).items()}


def rel_l2(got, want) -> float:
    den = max(float(np.linalg.norm(want)), 1e-12)
    return float(np.linalg.norm(got - want)) / den


def hold_tree(cfg, model, got: dict, want_tree, tol, rel=True):
    """The port's ``{name: tensor}`` against the reference's tree, rep by
    rep: relative L2 within ``tol`` (or max |d| with ``rel=False``)."""
    want = flat(want_tree)
    got = per_leaf(cfg, model, got)
    assert sorted(got) == sorted(want)
    for path, parts in got.items():
        stacked = path[0] in M.STACKS
        for r, g in enumerate(parts):
            w = want[path][r] if stacked else want[path]
            assert g.shape == w.shape, path
            err = rel_l2(g, w) if rel else float(np.abs(g - w).max())
            assert err <= tol, (path, r, err)


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_loss_matches_reference(arch, over):
    _, _, cfg, model = pair(arch, over)
    _, tb = batch_of(cfg)
    jtot, jce, jaux = jax_loss(arch, over)
    with torch.no_grad():
        tot, (ce, aux) = steps.loss_fn(model, cfg, tb)
    for got, want in ((tot, jtot), (ce, jce), (aux, jaux)):
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=TOL)
    assert abs(float(ce) - np.log(cfg.vocab)) < 1.5
    if cfg.moe is not None:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_lower_the_loss(arch):
    _, _, cfg, model = pair(arch)
    _, tb = batch_of(cfg)
    step = steps.make_train_step(model, cfg, opt_lib.OptConfig(
        lr=1e-3, warmup=0, total_steps=10))
    params = steps.param_dict(model)
    before = {k: p.detach().clone() for k, p in params.items()}
    state = opt_lib.init(params)
    _, state, m1 = step(params, state, tb)
    _, state, m2 = step(params, state, tb)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"]), arch
    assert max(float((p - before[k]).abs().max())
               for k, p in params.items()) > 0
    assert set(m2) == {"loss", "aux", "lr", "grad_norm"}


def _spec(x):
    return tuple(x.shape), str(x.dtype).split(".")[-1]


def _leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, sub in tree.items():
            out.update(_leaves(sub, path + (k,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """``batch_specs``, ``prefill_specs`` and ``decode_specs`` of the full
    config at every shape: the reference's shapes and dtypes, as meta
    tensors (the decode cache one dict a rep, the reference's stacked
    over reps)."""
    jcfg, cfg = jconfigs.lm_config(arch), configs.lm_config(arch)
    for name, shape in jconfigs.SHAPES.items():
        tshape = configs.SHAPES[name]
        for f in ("batch_specs", "prefill_specs"):
            want = getattr(jsteps, f)(jcfg, shape)
            got = getattr(steps, f)(cfg, tshape)
            assert {k: _spec(v) for k, v in got.items()} == \
                {k: _spec(v) for k, v in want.items()}, (name, f)
            assert all(v.device.type == "meta" for v in got.values())
        if shape.kind != "decode":
            continue
        jtok, jcache, jpos = jsteps.decode_specs(jcfg, shape)
        tok, cache, pos = steps.decode_specs(cfg, tshape)
        assert _spec(tok) == _spec(jtok) and _spec(pos) == _spec(jpos)
        assert len(cache) == cfg.reps
        want = {path: (tuple(v.shape[1:]), str(v.dtype))
                for path, v in _leaves(jcache).items()}
        for rep in cache:
            got = {path: _spec(v) for path, v in _leaves(rep).items()}
            assert got == want, name
            assert all(v.device.type == "meta"
                       for v in _leaves(rep).values())
