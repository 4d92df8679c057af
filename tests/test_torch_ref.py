"""The port's global point ops (``point_ops="global"``) against the JAX
package's ``repro.core.ref``, on the CPU.

The same numpy clouds go through both: two clouds as one batch on the
port's side, one at a time (the JAX functions take one cloud) on the
other.  The clouds hold exact duplicates and a tight cluster of repeated
points, so distances tie and the lowest-index rule of ``jax.lax.top_k``
is exercised; one cloud has a padded (invalid) tail and one center is
invalid.  Indices, counts and masks must match exactly; distances within
1e-5; interpolated features and weights within 1e-5 (inverse distances
of nearly coincident points amplify a last-ulp difference, the bound
tests/test_torch_bppo.py states for the block-parallel interpolation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ref as jref  # noqa: E402
from repro_torch.core import ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


def clouds(seed=0, b=2, n=300):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    pts[:, 40:60] = pts[:, 10:30]                 # exact duplicates
    pts[:, 100:120] = pts[:, 99:100]              # 21 copies of one point
    pts[:, 200:205] = 0.0
    valid = np.ones((b, n), bool)
    valid[1, -37:] = False                        # a padded tail
    return pts, valid


def t(x):
    return torch.from_numpy(np.array(x))


def per_cloud(fn, *arrays):
    """Run a one-cloud JAX function on each cloud; stack its outputs."""
    outs = [fn(*(jnp.asarray(a[i]) for a in arrays))
            for i in range(arrays[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[j]) for o in outs])
                     for j in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def test_pairwise_sqdist_is_the_difference_form():
    pts, _ = clouds()
    got = ref.pairwise_sqdist(t(pts[:, :50]), t(pts)).numpy()
    want = per_cloud(jref.pairwise_sqdist, pts[:, :50], pts)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[:, 10, 40] == 0).all()            # a duplicate: exactly 0


@pytest.mark.parametrize("k", [1, 64, 300])
def test_fps_matches_jax(k):
    pts, valid = clouds()
    valid[0, :3] = False                          # start past lane 0
    idx, sel = ref.fps(t(pts), t(valid), k)
    want_idx, want_sel = per_cloud(lambda c, v: jref.fps(c, v, k), pts,
                                   valid)
    assert idx.dtype == torch.int32 and idx.shape == (2, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(sel.numpy(), want_sel)
    assert idx[0, 0] == 3


def test_fps_on_an_all_invalid_cloud():
    pts, valid = clouds(1)
    valid[1] = False
    idx, sel = ref.fps(t(pts), t(valid), 9)
    want_idx, want_sel = per_cloud(lambda c, v: jref.fps(c, v, 9), pts,
                                   valid)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(sel.numpy(), want_sel)
    assert not sel[1].any() and (idx[1] == 0).all()


@pytest.mark.parametrize("radius,num", [(0.3, 8), (0.9, 16), (0.05, 4)])
def test_ball_query_matches_jax(radius, num):
    pts, valid = clouds(2)
    centers = pts[:, ::7].copy()
    cvalid = np.ones(centers.shape[:2], bool)
    cvalid[0, 3] = False                          # an invalid center
    idx, cnt = ref.ball_query(t(pts), t(valid), t(centers), t(cvalid),
                              radius, num, chunk=16)
    want_idx, want_cnt = per_cloud(
        lambda s, sv, c, cv: jref.ball_query(s, sv, c, cv, radius, num),
        pts, valid, centers, cvalid)
    assert idx.shape == (2, centers.shape[1], num)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    assert cnt[0, 3] == 0


@pytest.mark.parametrize("k", [1, 3, 20])
def test_knn_matches_jax(k):
    pts, valid = clouds(3)
    queries = np.random.default_rng(4).normal(0, 1, (2, 90, 3)).astype(
        np.float32)
    queries[:, :20] = pts[:, 100:120]             # on a repeated point
    idx, d2 = ref.knn(t(pts), t(valid), t(queries), k, chunk=32)
    want_idx, want_d2 = per_cloud(lambda s, sv, q: jref.knn(s, sv, q, k),
                                  pts, valid, queries)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=TOL, atol=TOL)
    assert (idx[:, :20, 0] == 99).all()           # lowest of the copies


def test_knn_with_fewer_valid_points_than_k():
    """Past the valid points top_k returns the lowest invalid lanes at
    INF, never a repeat."""
    pts, valid = clouds(5)
    valid[0, 2:] = False
    idx, d2 = ref.knn(t(pts), t(valid), t(pts[:, :5]), 6)
    want_idx, want_d2 = per_cloud(lambda s, sv, q: jref.knn(s, sv, q, 6),
                                  pts, valid, pts[:, :5])
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=TOL, atol=TOL)
    assert sorted(idx[0, 0].tolist()) == list(range(6))


def test_interpolate_3nn_and_gather_match_jax():
    pts, valid = clouds(6)
    src = pts[:, ::4].copy()
    svalid = valid[:, ::4].copy()
    feats = np.random.default_rng(7).normal(0, 1, (2, src.shape[1], 5)
                                            ).astype(np.float32)
    out, idx, w = ref.interpolate_3nn(t(pts), t(src), t(svalid), t(feats))
    want = per_cloud(jref.interpolate_3nn, pts, src, svalid, feats)
    np.testing.assert_array_equal(idx.numpy(), want[1])
    np.testing.assert_allclose(w.numpy(), want[2], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), want[0], rtol=TOL, atol=TOL)
    g = ref.gather(t(feats), idx).numpy()
    np.testing.assert_array_equal(
        g, per_cloud(jref.gather, feats, want[1]))


def test_smallest_orders_ties_by_index():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.0, 3e38, 1.0, 0.0]])
    idx, val = ref.smallest(d, 7)
    assert idx.tolist() == [[3, 6, 1, 2, 5, 0, 4]]
    assert torch.equal(val, d[:, idx[0].long()])
