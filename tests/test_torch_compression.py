"""The port's gradient codecs and error feedback against the JAX package,
on the CPU.

bf16 is held bit for bit; int8 payload and scale exactly, given the
reference's own ``jax.random.uniform`` draws as the uniforms (the port's
random stream is its own: a hash of (seed, step, leaf, element)).  The
four codec checks of tests/test_train_infra.py are repeated on the port;
one compressed train step (grads -> error feedback -> AdamW) on converted
weights lands within 1e-4 (relative L2 per parameter) of the reference's
same three calls (tests/test_torch_compression_step.py: one JAX compile
each, so it runs on another worker); a CPU ``fit`` with each codec lowers
the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import compression as jcomp  # noqa: E402
from repro_torch.dist import compression  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

KEY = jax.random.PRNGKey(0)
INT8_EF_TOL = 1e-7


def edge_values() -> np.ndarray:
    """Zeros, subnormals, values near the float32 limits and exact ties
    between two bf16 neighbours (both parities), then seeded normals."""
    ties = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 + 2 ** -7,
            1.00390625 * 2 ** 100, 1 + 2 ** -8 + 2 ** -20]
    special = [0.0, -0.0, 1e-40, -3e-39, 1.4e-45, 1.17549435e-38, 3.3e38,
               -3.39e38, 3.4028235e38, 65504.0, 1e-30]
    rng = np.random.default_rng(0)
    return np.concatenate([np.array(ties + special, np.float32),
                           rng.normal(0, 3, 500).astype(np.float32)])


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# The codecs against the reference.
# ---------------------------------------------------------------------------

def test_bf16_matches_the_reference_bit_for_bit():
    x = edge_values()
    jp, jm = jcomp.compress(jnp.asarray(x), "bf16")
    p, m = compression.compress(torch.from_numpy(x), "bf16")
    assert m is None and jm is None and p.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(p.float().numpy()),
                                  bits(jnp.asarray(jp, jnp.float32)))
    want = jcomp.roundtrip(jnp.asarray(x), "bf16")
    got = compression.roundtrip(torch.from_numpy(x), "bf16")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("shape,scale,seed", [((1024,), 1.0, 0),
                                              ((7, 33), 1e-3, 1),
                                              ((5, 4, 3), 250.0, 2),
                                              ((64,), 1e-30, 3)])
def test_int8_matches_the_reference_given_its_uniforms(shape, scale, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    x.flat[0] = 0.0
    key = jax.random.PRNGKey(seed)
    jp, jm = jcomp.compress(jnp.asarray(x), "int8", key)
    u = np.asarray(jax.random.uniform(key, shape))
    p, m = compression._quantize_int8(torch.from_numpy(x),
                                      torch.from_numpy(u.copy()))
    assert p.dtype == torch.int8 and m.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert bits(m.numpy()) == bits(jm)
    np.testing.assert_array_equal(
        bits(compression.decompress(p, m, "int8").numpy()),
        bits(jcomp.decompress(jp, jm, "int8")))


def test_unknown_method_and_missing_key_raise_as_the_reference():
    x = torch.ones(4)
    for fn in (lambda: compression.compress(x, "fp4"),
               lambda: compression.decompress(x, None, "fp4")):
        with pytest.raises(ValueError, match=r"unknown compression method "
                           r"'fp4'; have \('bf16', 'int8'\)"):
            fn()
    with pytest.raises(ValueError, match="needs a PRNG key"):
        compression.compress(x, "int8")
    with pytest.raises(ValueError, match="needs a PRNG key"):
        jcomp.compress(jnp.ones(4), "int8")


def test_uniform_stream_is_counter_based():
    a = compression.uniform((3, 7, 1), (4, 5), "cpu")
    assert a.dtype == torch.float32 and a.shape == (4, 5)
    assert bool(((a >= 0) & (a < 1)).all())
    assert torch.equal(a, compression.uniform((3, 7, 1), (4, 5), "cpu"))
    # the stream is flat over elements: a shape is a view of it
    assert torch.equal(a.reshape(-1), compression.uniform((3, 7, 1), (20,),
                                                          "cpu"))
    assert not torch.equal(a, compression.uniform((3, 7, 2), (4, 5), "cpu"))
    assert not torch.equal(a, compression.uniform((3, 8, 1), (4, 5), "cpu"))


def leaves(seed=0):
    """A small parameter-like tree, in the reference's (sorted) key order
    and in another order for the port."""
    rng = np.random.default_rng(seed)
    names = {"b": (6,), "a/w": (5, 3), "c": (2, 2, 2)}
    return {k: (rng.normal(0, 1, s) * 10.0 ** -i).astype(np.float32)
            for i, (k, s) in enumerate(names.items())}


def reference_uniforms(tree: dict, key) -> dict:
    """The uniforms the reference's ``apply_error_feedback`` draws for
    each leaf of the dict ``tree`` under ``key``."""
    names = sorted(tree)                      # jax's order for dict keys
    keys = jax.random.split(key, len(names))
    return {k: np.asarray(jax.random.uniform(kk, tree[k].shape))
            for k, kk in zip(names, keys)}


def feed_uniforms(monkeypatch, names: list, u: dict):
    """Make the port's leaf ``i`` (of ``names``) draw ``u[names[i]]``."""
    def uniform(key, shape, device):
        got = torch.from_numpy(u[names[key[-1]]].copy()).to(device)
        assert tuple(got.shape) == tuple(shape)
        return got
    monkeypatch.setattr(compression, "uniform", uniform)


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_error_feedback_matches_the_reference(method, monkeypatch):
    g0, g1 = leaves(0), leaves(1)
    key0, key1 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    jres = jcomp.init_residual({k: jnp.asarray(v) for k, v in g0.items()})
    order = ["c", "a/w", "b"]
    res = compression.init_residual({k: torch.from_numpy(g0[k])
                                     for k in order})
    assert list(res) == order and all(r.dtype == torch.float32
                                      for r in res.values())
    for g, key in ((g0, key0), (g1, key1)):
        jout, jres = jcomp.apply_error_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jres, method, key)
        if method == "int8":
            feed_uniforms(monkeypatch, order, reference_uniforms(g, key))
        out, res = compression.apply_error_feedback(
            {k: torch.from_numpy(g[k]) for k in order}, res, method,
            (0, 0))
        assert list(out) == order
        for k in order:
            for got, want in ((out[k], jout[k]), (res[k], jres[k])):
                if method == "bf16":
                    np.testing.assert_array_equal(bits(got.numpy()),
                                                  bits(want), err_msg=k)
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=INT8_EF_TOL,
                                               atol=INT8_EF_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_train_infra.py's codec checks, on the port.
# ---------------------------------------------------------------------------

class TestCompression:
    def test_int8_roundtrip_error_bounded(self):
        x = torch.randn(1024, generator=torch.Generator().manual_seed(0))
        payload, meta = compression.compress(x, "int8", (0, 0))
        rec = compression.decompress(payload, meta, "int8")
        assert float((rec - x).abs().max()) <= float(meta / 127.0) + 1e-6

    def test_stochastic_rounding_unbiased(self):
        x = torch.full((20000,), 0.3)
        recs = []
        for k in range(8):
            p, m = compression.compress(x, "int8", (0, k))
            recs.append(compression.decompress(p, m, "int8").mean())
        assert abs(float(torch.stack(recs).mean()) - 0.3) < 1e-3

    def test_error_feedback_converges(self):
        # compressed grad descent with EF reaches the optimum anyway
        target = torch.from_numpy(
            np.random.default_rng(1).normal(0, 1, (16,)).astype(np.float32))
        w = {"w": torch.zeros(16)}
        res = compression.init_residual(w)
        for i in range(300):
            g = {"w": 2 * (w["w"] - target)}
            g, res = compression.apply_error_feedback(g, res, "int8", (0, i))
            w = {"w": w["w"] - 0.05 * g["w"]}
        assert float((w["w"] - target).abs().max()) < 0.02

    def test_bf16_codec(self):
        x = torch.randn(128, generator=torch.Generator().manual_seed(0))
        p, m = compression.compress(x, "bf16")
        rec = compression.decompress(p, m, "bf16")
        assert float((rec - x).abs().max()) < 0.01


# ---------------------------------------------------------------------------
# The trainer with compression.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["int8", "bf16"])
def test_cpu_fit_with_compression_lowers_the_loss(method):
    cfg = train.TrainConfig(preset="pointnet2_seg", n_points=256, th=64,
                            batch=2, steps=20, device="cpu",
                            grad_compression=method)
    _, state, info = train.fit(cfg, log=lambda *_: None)
    losses = [h["loss"] for h in info["history"]]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert state["step"] == 20
