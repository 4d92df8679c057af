"""The port's LM (``repro_torch.lm.model``) against the JAX package's, on
the ten reduced configs, within 1e-4 (the bar the PNN logits hold): the
full forward's hidden states, MoE aux loss and ``lm_loss`` of each, and
seamless's encoder on its own; gemma3 (window 16) prefills 20 tokens and
decodes 8 teacher-forced steps, so its rolling caches wrap, and zamba2's
shared attention (window 64) does the same past a 70-token prompt.
``test_torch_lm_decode.py`` holds prefill and decode of all ten, and
``test_torch_lm_kinds.py`` each block kind alone, with the helpers of
this file.

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
from repro_torch import configs, convert  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4
B, S, PROMPT, STEPS = 2, 16, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def close_logits(got, want, vocab, tol=TOL):
    close(got[..., :vocab], np.asarray(want)[..., :vocab], tol)
    assert (got[..., vocab:] == -1e30).all()


@functools.lru_cache(maxsize=None)
def pair(arch, seed=0, **overrides):
    """(JAX config, params; port config, model) with the same weights."""
    jcfg = jconfigs.lm_reduced(arch, **overrides)
    cfg = configs.lm_reduced(arch, **overrides)
    params, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


def inputs(cfg, s, seed=1):
    """{name: (JAX array, torch tensor)} of a batch for ``cfg``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, s))
    out = {"dec_tokens" if cfg.encoder_layers else "tokens": toks}
    if cfg.encoder_layers:
        out["frames"] = (rng.standard_normal((B, s, cfg.d_model))
                         * 0.1).astype(np.float32)
    return {k: (jnp.asarray(v), torch.from_numpy(v)) for k, v in out.items()}


def sides(batch, upto=None):
    def cut(k, v):
        return v if k == "frames" or upto is None else v[:, :upto]
    return ({k: cut(k, j) for k, (j, _) in batch.items()},
            {k: cut(k, t) for k, (_, t) in batch.items()})


def flat(tree, path=""):
    """{"a/b": leaf} of a tree of dicts."""
    if not isinstance(tree, dict):
        return {path: tree}
    return {k: v for key, sub in tree.items()
            for k, v in flat(sub, f"{path}/{key}" if path else key).items()}


def hold_cache(cache, jcache, cfg):
    """Every rep's cache (KV, SSD and conv states, mLSTM / sLSTM states)
    against the reference's, stacked over reps."""
    assert len(cache) == cfg.reps
    jflat = flat(jcache)
    for r, rep in enumerate(cache):
        got = flat(rep)
        assert set(got) == set(jflat)
        for key, t in got.items():
            want = np.asarray(jflat[key][r])
            assert tuple(t.shape) == want.shape, (r, key)
            assert str(t.dtype) == f"torch.{want.dtype}", (r, key)
            close(t, want)


ARCHS = sorted(configs.ARCHS)


def run_serving(arch, prompt, steps, max_len, **overrides):
    """Prefill ``prompt`` tokens, then ``steps`` teacher-forced decode
    steps, both sides, holding logits and caches as they go."""
    jcfg, params, cfg, model = pair(arch, **overrides)
    jb, tb = sides(inputs(cfg, prompt), prompt)
    jlast, jcache = jmodel.prefill(params, jcfg, max_len=max_len, **jb)
    last, cache = M.prefill(model, cfg, max_len=max_len, **tb)
    close_logits(last, jlast, cfg.vocab)
    hold_cache(cache, jcache, cfg)
    for i in range(steps):
        nxt = jnp.argmax(jlast, -1)
        jlast, jcache = jmodel.decode_step(params, jcfg, nxt, jcache,
                                           jnp.int32(prompt + i))
        last, cache = M.decode_step(model, cfg,
                                    torch.from_numpy(np.array(nxt)), cache,
                                    prompt + i)
        close_logits(last, jlast, cfg.vocab)
    hold_cache(cache, jcache, cfg)
    return cfg, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    jcfg, params, cfg, model = pair(arch)
    jb, tb = sides(inputs(cfg, S))
    jh, jaux = jmodel.forward(params, jcfg, **jb)
    h, aux = M.forward(model, cfg, **tb)
    close(h, jh)
    close(aux, jaux)
    assert (float(aux.detach()) > 0) == ("moe" in cfg.pattern)
    targets = np.array(jb.get("tokens", jb.get("dec_tokens")))
    jloss = jmodel.lm_loss(params, jcfg, jh, jnp.asarray(targets))
    loss = M.lm_loss(model, cfg, h, torch.from_numpy(targets))
    close(loss, jloss)


def test_seamless_encoder():
    jcfg, params, cfg, model = pair("seamless-m4t-medium")
    frames = inputs(cfg, S)["frames"]
    close(M.encode(model, cfg, frames[1]),
          jmodel.encode(params, jcfg, frames[0]))


def test_gemma3_rolling_caches_wrap():
    """Window 16 under a 20-token prompt and 8 steps: every local layer's
    cache holds the last 16 keys at slots ``pos % 16`` and wraps again."""
    cfg, _ = run_serving("gemma3-12b", 20, 8, 28)
    assert cfg.window == 16


def test_zamba2_shared_attention_cache_wraps():
    """Window 64 under a 70-token prompt and 4 steps: each rep's cache of
    the one shared attention block holds the last 64 keys and wraps."""
    cfg, _ = run_serving("zamba2-7b", 70, 4, 74)
    assert cfg.window == 64 and "shared_attn" in cfg.pattern

