"""The port's Fractal partition against the JAX package, field by field.

Every ``FractalPartition`` field must be equal exactly, for all four
strategies, with a bucket-padded tail and a phased split cycle (``dim0``);
the batched partition of B clouds must equal each cloud's own partition.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fractal as jfr  # noqa: E402
from repro_torch.core import fractal as fr  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FIELDS = [f for f in fr.FractalPartition.__dataclass_fields__]


def make_cloud(seed, n, kind="clusters"):
    rng = np.random.default_rng(seed)
    if kind == "clusters":
        k = max(1, n // 150)
        centers = rng.uniform(-3, 3, (k, 3))
        pts = np.concatenate([rng.normal(c, rng.uniform(0.1, 0.5),
                                         (n // k, 3)) for c in centers])
        pts = np.concatenate([pts, rng.uniform(-3, 3, (n - len(pts), 3))])
    else:  # coplanar: the degenerate-dimension case
        pts = rng.uniform(-1, 1, (n, 3))
        pts[:, 2] = 0.25
    return pts.astype(np.float32)


def padded(seed, n, real, kind="clusters"):
    pts = np.zeros((n, 3), np.float32)
    pts[:real] = make_cloud(seed, real, kind)
    return pts, np.arange(n) < real


@functools.lru_cache(maxsize=None)
def _jax_fn(th, strategy, depth):
    return jax.jit(lambda p, v, d: jfr.partition(
        p, v, th=th, strategy=strategy, depth=depth, dim0=d,
        on_overflow="silent"))


def jax_partition(pts, valid, *, th, strategy, dim0, depth=None):
    return _jax_fn(th, strategy, depth)(jnp.asarray(pts), jnp.asarray(valid),
                                        jnp.int32(dim0))


def assert_same(port_part, jax_part, i=0):
    for f in FIELDS:
        got = getattr(port_part, f)[i].numpy()
        want = np.asarray(getattr(jax_part, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


# (seed, n, real points, th, kind, dim0, depth).  The explicit depths keep
# the JAX compiles short; the default (log2 plus 9 levels of slack) has a
# case of its own below.
CASES = [
    (1, 640, 470, 40, "clusters", 2, 6),
    (2, 384, 300, 32, "plane", 1, 5),
]
DEFAULT_DEPTH_CASE = (0, 256, 256, 48, "clusters", 0, None)


@pytest.mark.parametrize("strategy", fr.STRATEGIES)
@pytest.mark.parametrize("case", CASES + [DEFAULT_DEPTH_CASE],
                         ids=lambda c: f"n{c[1]}-{c[2]}-d{c[6]}")
def test_partition_fields_match_jax(strategy, case):
    if case is DEFAULT_DEPTH_CASE and strategy != fr.FRACTAL:
        case = case[:-1] + (6,)
    seed, n, real, th, kind, dim0, depth = case
    pts, valid = padded(seed, n, real, kind)
    want = jax_partition(pts, valid, th=th, strategy=strategy, dim0=dim0,
                         depth=depth)
    got = fr.partition(torch.from_numpy(pts)[None],
                       torch.from_numpy(valid)[None], th=th, depth=depth,
                       strategy=strategy, dim0=dim0, on_overflow="silent")
    assert_same(got, want)


@pytest.mark.parametrize("strategy", [fr.FRACTAL, fr.OCTREE])
def test_batched_partition_equals_per_cloud(strategy):
    """Three clouds, each with its own padding and its own dim0 (a (B,)
    tensor), partitioned at once: each equals its own partition and the
    JAX partition of that cloud."""
    n, th, depth = 512, 40, 6
    clouds = [padded(s, n, real) for s, real in ((3, 512), (4, 333),
                                                 (5, 100))]
    pts = torch.from_numpy(np.stack([c for c, _ in clouds]))
    valid = torch.from_numpy(np.stack([v for _, v in clouds]))
    dim0 = torch.tensor([0, 1, 2])
    batched = fr.partition(pts, valid, th=th, depth=depth, strategy=strategy,
                           dim0=dim0, on_overflow="silent")
    for i in range(3):
        alone = fr.partition(pts[i:i + 1], valid[i:i + 1], th=th, depth=depth,
                             strategy=strategy, dim0=i, on_overflow="silent")
        for f in FIELDS:
            assert torch.equal(getattr(batched, f)[i], getattr(alone, f)[0]), f
        assert_same(batched, jax_partition(clouds[i][0], clouds[i][1], th=th,
                                           strategy=strategy, dim0=i,
                                           depth=depth), i)


def test_views_and_slot_ranges_match_jax():
    pts, valid = padded(6, 512, 450)
    jp = jax_partition(pts, valid, th=40, strategy=fr.FRACTAL, dim0=0,
                       depth=6)
    tp = fr.partition(torch.from_numpy(pts)[None],
                      torch.from_numpy(valid)[None], th=40, depth=6,
                      on_overflow="silent")
    for (a, b) in zip(fr.leaf_view(tp, tp.coords, 40),
                      jfr.leaf_view(jp, jp.coords, 40)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    for (a, b) in zip(fr.window_view(tp, tp.coords, 80),
                      jfr.window_view(jp, jp.coords, 80)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    total = tp.leaf_of_slot.shape[-1].bit_length() - 1
    for a, b in zip(
            fr.subtree_slot_range(tp, tp.leaf_depth, tp.slot_of_leaf, total),
            jfr.subtree_slot_range(jp, jp.leaf_depth, jp.slot_of_leaf,
                                   total)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


def test_static_helpers_match_jax():
    for n, th in [(4096, 256), (65536, 256), (289000, 256), (100, 256),
                  (1000, 7)]:
        d = fr.default_depth(n, th)
        assert d == jfr.default_depth(n, th)
        assert fr.max_leaves(n, th, d) == jfr.max_leaves(n, th, d)
    with pytest.raises(ValueError):
        fr.default_depth(10, 0)


def test_overflow_warns_and_check_raises():
    """Duplicate points cannot split: the depth cap leaves an overflowing
    leaf, which "warn" reports on the host and check_overflow raises."""
    pts = torch.zeros((1, 300, 3))
    with pytest.warns(fr.FractalOverflowWarning, match="th=32"):
        part = fr.partition(pts, th=32)
    assert bool(part.overflowed[0]) and int(part.max_leaf_vsize[0]) == 300
    with pytest.raises(fr.FractalOverflowError):
        fr.check_overflow(part, th=32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fr.partition(pts, th=32, on_overflow="silent")
        fr.partition(torch.from_numpy(make_cloud(0, 300))[None], th=32)


def test_argument_checks():
    pts = torch.zeros((1, 10, 3))
    with pytest.raises(ValueError, match="strategy"):
        fr.partition(pts, th=4, strategy="bogus")
    with pytest.raises(ValueError, match="on_overflow"):
        fr.partition(pts, th=4, on_overflow="loud")
    with pytest.raises(ValueError, match="B, n, 3"):
        fr.partition(pts[0], th=4)
