"""The port's block-parallel point ops against the JAX package.

Both packages partition the same padded clouds (the partitions are equal
field by field, tests/test_torch_fractal.py), then run block-wise FPS,
ball query, kNN and interpolation.  Sample layouts and neighbour indices
must be equal exactly and distances within 1e-5 (the expanded-form
distance rounds the last ulp differently in XLA's dot).  Interpolation
weights and features are held within 1e-4: inverse-distance weights turn
that last-ulp difference of a near-zero distance into a relative error of
about 1e-4.
Chunked runs must equal unchunked ones exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bppo as jbppo  # noqa: E402
from repro.core import fractal as jfr  # noqa: E402
from repro_torch.core import bppo, fractal  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N, REAL, TH, DEPTH = 512, 450, 48, 6
RATE, K_OUT, RADIUS, NUM = 0.25, 128, 0.5, 8
W, WC, C = 2 * TH, 24, 5


def clouds(batch=2):
    rng = np.random.default_rng(7)
    pts = np.zeros((batch, N, 3), np.float32)
    valid = np.zeros((batch, N), bool)
    for b in range(batch):
        real = REAL - 60 * b
        k = 3
        centers = rng.uniform(-2, 2, (k, 3))
        p = np.concatenate([rng.normal(c, 0.4, (real // k, 3))
                            for c in centers])
        p = np.concatenate([p, rng.uniform(-2, 2, (real - len(p), 3))])
        pts[b, :real] = p
        valid[b, :real] = True
    feats = rng.normal(0, 1, (batch, K_OUT, C)).astype(np.float32)
    return pts, valid, feats


@jax.jit
def jax_pipeline(pts, valid, feats):
    part = jfr.partition(pts, valid, th=TH, depth=DEPTH, on_overflow="silent")
    samp = jbppo.blockwise_fps(part, rate=RATE, k_out=K_OUT, bs=TH,
                               impl="xla")
    bq = jbppo.blockwise_ball_query(part, samp, radius=RADIUS, num=NUM, w=W,
                                    impl="xla")
    kn = jbppo.blockwise_knn(part, samp, k=3, w=W, impl="xla")
    ca, cb = jbppo.coarse_window_ranges(part, samp)
    interp = jbppo.blockwise_interpolate(part, samp, feats, wc=WC, bs=TH,
                                         impl="xla")
    return samp, bq, kn, (ca, cb), interp


def port_pipeline(pts, valid, feats, chunk=None):
    part = fractal.partition(pts, valid, th=TH, depth=DEPTH,
                             on_overflow="silent")
    samp = bppo.blockwise_fps(part, rate=RATE, k_out=K_OUT, bs=TH)
    bq = bppo.blockwise_ball_query(part, samp, radius=RADIUS, num=NUM, w=W,
                                   chunk=chunk)
    kn = bppo.blockwise_knn(part, samp, k=3, w=W, chunk=chunk)
    ranges = bppo.coarse_window_ranges(part, samp)
    interp = bppo.blockwise_interpolate(part, samp, feats, wc=WC, bs=TH,
                                        chunk=chunk)
    return samp, bq, kn, ranges, interp


@pytest.fixture(scope="module")
def results():
    pts, valid, feats = clouds()
    port = port_pipeline(torch.from_numpy(pts), torch.from_numpy(valid),
                         torch.from_numpy(feats))
    ref = [jax_pipeline(jnp.asarray(pts[b]), jnp.asarray(valid[b]),
                        jnp.asarray(feats[b])) for b in range(len(pts))]
    return port, ref, (pts, valid, feats)


def fields(obj):
    return obj.__dataclass_fields__


@pytest.mark.parametrize("b", [0, 1])
def test_blockwise_fps_matches_jax(results, b):
    (samp, *_), ref, _ = results
    assert int(ref[b][0].total) <= K_OUT            # no truncation here
    for f in fields(samp):
        np.testing.assert_array_equal(getattr(samp, f)[b].numpy(),
                                      np.asarray(getattr(ref[b][0], f)),
                                      err_msg=f)


@pytest.mark.parametrize("b", [0, 1])
@pytest.mark.parametrize("which", [1, 2], ids=["ball_query", "knn"])
def test_blockwise_neighbors_match_jax(results, b, which):
    port, ref, _ = results
    got, want = port[which], ref[b][which]
    for f in ("idx", "mask", "cnt"):
        np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.d2[b].numpy(), np.asarray(want.d2),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("b", [0, 1])
def test_blockwise_interpolate_matches_jax(results, b):
    port, ref, _ = results
    for x, y in zip(port[3], ref[b][3]):
        np.testing.assert_array_equal(x[b].numpy(), np.asarray(y))
    out, idx3, w3 = port[4]
    jout, jidx3, jw3 = ref[b][4]
    np.testing.assert_array_equal(idx3[b].numpy(), np.asarray(jidx3))
    np.testing.assert_allclose(w3[b].numpy(), np.asarray(jw3), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4)


def test_chunked_equals_unchunked(results):
    port, _, (pts, valid, feats) = results
    chunked = port_pipeline(torch.from_numpy(pts), torch.from_numpy(valid),
                            torch.from_numpy(feats), chunk=3)
    for a, b in zip(port[1:3], chunked[1:3]):
        for f in fields(a):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(port[4], chunked[4]):
        assert torch.equal(x, y)


def test_gather_is_a_per_cloud_take():
    feats = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    idx = torch.tensor([[[4, 0]], [[1, 1]]])
    out = bppo.gather(feats, idx)
    assert out.shape == (2, 1, 2, 3)
    assert torch.equal(out[0, 0, 0], feats[0, 4])
    assert torch.equal(out[1, 0, 1], feats[1, 1])
