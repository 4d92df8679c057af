"""The port's LM layers and attention (``repro_torch.lm.{layers,attention}``)
against the JAX package's, in float32 within 1e-5.

Inputs are made with numpy from a seed; weights come from the reference's
``*_init`` and are copied into the port's modules.  ``_sdpa_flash`` is
called directly at ``chunk=16`` over 45 keys (not a multiple), causal x
window x softcap with 3 queries a KV head; the flash branch of
``_dispatch_sdpa`` is also taken inside ``prefill_attention`` with the
threshold lowered on both sides.  The rolling cache of a local layer is
held through its wrap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import attention as jattn  # noqa: E402
from repro.lm import layers as jlayers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.lm import attention as attn  # noqa: E402
from repro_torch.lm import layers  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def port(module, tree):
    """Copy a reference parameter tree into a port module."""
    convert._load(module, jax.tree.map(np.asarray, tree), "p", set())
    return module


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, g = normal(rng, (2, 5, 16)), normal(rng, (16,))
    p = port(layers.rmsnorm_init(16)[0], {"g": g})
    close(layers.rmsnorm(p, torch.from_numpy(x)),
          jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = normal(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 9000, (2, 7))
    close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(cap):
    x = normal(np.random.default_rng(2), (4, 9), 40.0)
    close(layers.softcap(torch.from_numpy(x), cap),
          jlayers.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2"])
def test_mlp(kind):
    rng = np.random.default_rng(3)
    jp, jaxes = jlayers.mlp_init(jax.random.PRNGKey(3), 16, 40, kind)
    p, axes = layers.mlp_init(torch.Generator().manual_seed(0), 16, 40, kind)
    assert axes == jaxes
    port(p, jp)
    x = normal(rng, (2, 5, 16))
    close(layers.mlp(p, torch.from_numpy(x), kind),
          jlayers.mlp(jp, jnp.asarray(x), kind))


@pytest.mark.parametrize("cap", [None, 20.0])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa(masked, cap):
    rng = np.random.default_rng(4)
    q = normal(rng, (2, 5, 6, 16))
    k, v = normal(rng, (2, 9, 2, 16)), normal(rng, (2, 9, 2, 16))
    mask = rng.random((2, 1, 1, 5, 9)) < 0.7 if masked else None
    mask_t = None if mask is None else torch.from_numpy(mask)
    mask_j = None if mask is None else jnp.asarray(mask)
    close(attn._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), mask_t, scale=0.25, cap=cap),
          jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask_j, scale=0.25, cap=cap))


@pytest.mark.parametrize("cap", [None, 20.0])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_flash(causal, window, cap):
    rng = np.random.default_rng(5)
    q = normal(rng, (2, 45, 6, 8))
    k, v = normal(rng, (2, 45, 2, 8)), normal(rng, (2, 45, 2, 8))
    kw = dict(scale=8 ** -0.5, cap=cap, causal=causal, window=window,
              chunk=16)
    close(attn._sdpa_flash(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw),
          jattn._sdpa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw))


KW = dict(n_heads=6, n_kv=2, head_dim=8, rope_theta=10_000.0)


def attn_pair(qk_norm=False, seed=6):
    jp, jaxes = jattn.attn_init(jax.random.PRNGKey(seed), 16, 6, 2, 8,
                                qk_norm=qk_norm)
    p, axes = attn.attn_init(torch.Generator().manual_seed(0), 16, 6, 2, 8,
                             qk_norm=qk_norm)
    assert axes == jaxes
    if qk_norm:  # non-trivial norm gains
        rng = np.random.default_rng(seed)
        jp = dict(jp, qn={"g": jnp.asarray(normal(rng, (8,)))},
                  kn={"g": jnp.asarray(normal(rng, (8,)))})
    return port(p, jp), jp


@pytest.mark.parametrize("case", ["causal", "window", "cap_qknorm",
                                  "cross", "encoder"])
def test_full_attention(case):
    rng = np.random.default_rng(7)
    p, jp = attn_pair(qk_norm=case == "cap_qknorm")
    x = normal(rng, (2, 11, 16))
    kw = dict(KW)
    if case == "window":
        kw["window"] = 4
    if case == "cap_qknorm":
        kw.update(cap=5.0, qk_norm=True, scale=0.3)
    if case == "encoder":
        kw["causal"] = False
    tx, jx = {}, {}
    if case == "cross":
        enc = normal(rng, (2, 13, 16))
        tx, jx = ({"x_kv": torch.from_numpy(enc), "use_rope": False},
                  {"x_kv": jnp.asarray(enc), "use_rope": False})
    got, (gk, gv) = attn.full_attention(p, torch.from_numpy(x),
                                        return_kv=True, **kw, **tx)
    want, (wk, wv) = jattn.full_attention(jp, jnp.asarray(x),
                                          return_kv=True, **kw, **jx)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [None, 6])
def test_prefill_and_decode_attention(window, flash, monkeypatch):
    """Prefill 10 positions into a cache for 16, then decode 5 steps; a
    6-slot rolling cache is filled past its size and wraps again."""
    if flash:  # take the chunked branch at this size, on both sides
        monkeypatch.setattr(attn, "FLASH_THRESHOLD", 8)
        monkeypatch.setattr(jattn, "FLASH_THRESHOLD", 8)
    rng = np.random.default_rng(8)
    p, jp = attn_pair(qk_norm=True)
    kw = dict(KW, window=window, cap=30.0, qk_norm=True)
    x = normal(rng, (2, 10, 16))
    y, cache = attn.prefill_attention(p, torch.from_numpy(x), max_len=16,
                                      flash_chunk=4, **kw)
    jy, jcache = jattn.prefill_attention(jp, jnp.asarray(x), max_len=16,
                                         flash_chunk=4, **kw)
    close(y, jy)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        close(cache[key], jcache[key])
    for step in range(5):
        xt = normal(rng, (2, 1, 16))
        y, cache = attn.decode_attention(p, torch.from_numpy(xt), cache,
                                         10 + step, **kw)
        jy, jcache = jattn.decode_attention(jp, jnp.asarray(xt), jcache,
                                            jnp.int32(10 + step), **kw)
        close(y, jy)
        for key in ("k", "v"):
            close(cache[key], jcache[key])


def test_cross_decode_reads_the_encoder_cache_unchanged():
    rng = np.random.default_rng(9)
    p, jp = attn_pair()
    enc = {"k": normal(rng, (2, 13, 2, 8)), "v": normal(rng, (2, 13, 2, 8))}
    cache = {k: torch.from_numpy(v.copy()) for k, v in enc.items()}
    xt = normal(rng, (2, 1, 16))
    y, out = attn.decode_attention(p, torch.from_numpy(xt), cache, 5,
                                   cross=True, use_rope=False, **KW)
    jy, _ = jattn.decode_attention(jp, jnp.asarray(xt),
                                   {k: jnp.asarray(v) for k, v in enc.items()},
                                   jnp.int32(5), cross=True, use_rope=False,
                                   **KW)
    close(y, jy)
    for key in ("k", "v"):
        assert np.array_equal(out[key].numpy(), enc[key])


def test_decode_past_the_cache_raises():
    """The reference clamps the write onto the last slot
    (``dynamic_update_slice``); the port refuses it."""
    p, _ = attn_pair()
    x = torch.zeros((1, 1, 16))
    cache = attn.init_cache(1, 4, 2, 8)
    attn.decode_attention(p, x, cache, 3, **KW)
    with pytest.raises(ValueError, match="past a cache of 4 slots"):
        attn.decode_attention(p, x, cache, 4, **KW)
    # a rolling cache has no end
    rolling = attn.init_cache(1, 16, 2, 8, window=4)
    attn.decode_attention(p, x, rolling, 9, window=4, **KW)
