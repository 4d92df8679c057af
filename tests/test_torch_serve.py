"""The port's serving engine: admission, queue, plan cache, and its logits
against the JAX package's ``ServeEngine``.

Both engines serve the same mixed-size stream at buckets (128, 256),
th=64, with the JAX engine's weights carried over by
``repro_torch.convert``; per-request logits must agree within 1e-4.  The
port runs on the CPU here (``device="cpu"``: the plain kernel versions);
without a device argument it needs a card and raises.
"""
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core import fractal  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def cloud(n, seed=0):
    """Three displaced blobs, made with numpy (no per-size JAX compile)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.5, 2.5, (3, 3))
    pts = centers[rng.integers(0, 3, n)] + rng.normal(0, 0.3, (n, 3))
    return pts.astype(np.float32)


KW = dict(buckets=(128, 256), microbatch=2, max_wait_s=1.0,
          variant="pointnet2", task="seg", th=64)
SIZES = [100, 128, 256, 200, 90, 180]


@pytest.fixture(scope="module")
def engines():
    jeng = jserve.ServeEngine(jserve.ServeConfig(impl="xla", **KW), seed=3)
    params = convert.from_jax(jax.tree.map(np.asarray, jeng.params),
                              jeng._model_cfg(128))
    clock = FakeClock()
    teng = serve.ServeEngine(serve.ServeConfig(**KW), params=params,
                             clock=clock, device="cpu")
    teng.warm()
    return jeng, teng, clock


def test_engine_matches_jax_engine(engines):
    jeng, teng, clock = engines
    clouds = [cloud(n, i) for i, n in enumerate(SIZES)]
    jrids = [jeng.submit(c) for c in clouds]
    trids = [teng.submit(c, now=clock()) for c in clouds]
    jeng.flush()
    assert sorted(teng.flush()) == sorted(trids)
    for jr, tr, c in zip(jrids, trids, clouds):
        got, want = teng.take(tr), np.asarray(jeng.take(jr))
        assert got.shape == want.shape == (len(c), 6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_one_build_per_bucket_and_cache_hits(engines):
    _, teng, clock = engines
    traces0 = dict(teng.plans.traces)
    hits0 = sum(teng.plans.hits.values())
    for i, n in enumerate([60, 128, 250]):
        teng.submit(cloud(n, 10 + i), now=clock())
    teng.flush()
    assert dict(teng.plans.traces) == traces0
    assert sum(teng.plans.hits.values()) > hits0
    assert sorted(k for k in teng.plans.keys()) == sorted(
        [("plan", b, 64, "fractal") for b in (128, 256)]
        + [("serve", b, "plain") for b in (128, 256)])
    assert all(v == 1 for v in teng.plans.traces.values())
    assert ("serve", 128, "plain") in teng.plans and len(teng.plans) == 4


def test_deadline_flush_and_injected_clock(engines):
    _, teng, clock = engines
    clock.t = 100.0
    rid = teng.submit(cloud(90, 7), now=clock())
    assert teng.step() == []                    # partial, deadline not hit
    clock.t = 100.5
    assert teng.step() == []
    clock.t = 101.25
    assert teng.step() == [rid]
    lat, _ = teng._lat[128][-1]
    assert lat == pytest.approx(1.25)
    assert teng.take(rid).shape == (90, 6) and teng.take(rid) is None


def test_stats_report_percentiles():
    eng = serve.ServeEngine(serve.ServeConfig(**KW), clock=FakeClock(5.0),
                            device="cpu")
    assert eng.stats()["clouds_per_s"] is None
    eng.submit(cloud(40))
    assert eng.step() == []
    assert eng.stats()["buckets"] == {}
    eng.flush(now=5.0)                          # zero-width window
    assert eng.stats()["clouds_per_s"] is None
    eng.submit(cloud(30), now=5.5)
    eng.flush(now=6.0)
    st = eng.stats()
    assert st["impl"] == "plain" and st["served"] == 2
    assert st["clouds_per_s"] == pytest.approx(2.0)
    row = st["buckets"][128]
    assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]


def test_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ServeEngine(serve.ServeConfig(**KW))


def test_overflow_warns_at_the_plan_boundary():
    """A cloud of duplicates cannot split: the warning comes from the
    engine's host check after the microbatch, not from inside the forward."""
    eng = serve.ServeEngine(serve.ServeConfig(**{**KW, "microbatch": 1}),
                            device="cpu")
    with pytest.warns(fractal.FractalOverflowWarning):
        eng.submit(np.zeros((200, 3), np.float32))
        eng.flush()
    quiet = serve.ServeEngine(
        serve.ServeConfig(**{**KW, "microbatch": 1, "on_overflow": "silent"}),
        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.submit(np.zeros((200, 3), np.float32))
        quiet.flush()


def test_bucket_policy_and_queue():
    policy = serve.BucketPolicy((16384, 4096, 65536))
    assert policy.buckets == (4096, 16384, 65536)
    assert [policy.select(n) for n in (1, 4096, 4097, 65536)] == [
        4096, 4096, 16384, 65536]
    with pytest.raises(ValueError, match="exceeds"):
        policy.select(65537)
    with pytest.raises(ValueError, match="non-empty"):
        policy.select(0)
    with pytest.raises(ValueError, match="positive"):
        serve.BucketPolicy(())
    b, c, v = policy.pad(torch.zeros((3000, 3)))
    assert b == 4096 and c.shape == (4096, 3) and int(v.sum()) == 3000
    assert serve.mixed_request_sizes((4096, 16384, 65536), 8, seed=0) == \
        jserve.mixed_request_sizes((4096, 16384, 65536), 8, seed=0)

    q = serve.MicroBatchQueue(serve.BucketPolicy((64, 128)), microbatch=3,
                              max_wait_s=0.5)
    r1 = q.submit(torch.zeros((50, 3)), now=0.0)
    r2 = q.submit(torch.zeros((60, 3)), now=0.1)
    assert r1.bucket == r2.bucket == 64 and q.pending() == 2
    assert q.ready(now=0.4) == []
    (mb,) = q.ready(now=0.6)
    assert mb.deadline_flush and [r.rid for r in mb.requests] == [0, 1]
    for _ in range(4):
        q.submit(torch.zeros((100, 3)), now=1.0)
    (full,) = q.ready(now=1.0)
    assert len(full.requests) == 3 and not full.deadline_flush
    (rest,) = q.drain()
    assert len(rest.requests) == 1 and q.pending() == 0
