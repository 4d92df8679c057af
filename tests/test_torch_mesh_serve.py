"""Serving and scenes on a (data, model) mesh of CPU ranks, against the
port's one-process engine and the JAX package's engine.

Four gloo ranks form a (2, 2) mesh (``ServeConfig(mesh="auto",
model_axis=2)``): each takes its share of a microbatch's clouds over
"data" and of the leaf blocks over "model"; every rank's results must
equal the one-process engine's within rtol/atol 1e-5 (the bar of the
reference's ``test_mesh_dispatch_matches_single_device``).  Microbatch 3
does not divide data=2, so its clouds stay whole on every rank and only
the leaves split.  Rank 0's clock passes every deadline and the others'
never moves: they dispatch what rank 0 decides.  The logits also agree
with the JAX engine on the same clouds and converted weights, within the
port's 1e-4.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

from test_torch_mesh import (run_ranks, segment_scene,  # noqa: E402
                             serve_stream)

jax.config.update("jax_platform_name", "cpu")

KW = dict(buckets=(128, 256), max_wait_s=1.0, variant="pointnet2",
          task="seg", th=64)
SIZES = [100, 128, 90, 120, 60, 110, 75]   # one bucket: one JAX compile


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.5, 2.5, (3, 3))
    pts = centers[rng.integers(0, 3, n)] + rng.normal(0, 0.3, (n, 3))
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's weights (converted) and its logits."""
    jeng = jserve.ServeEngine(jserve.ServeConfig(impl="xla", microbatch=2,
                                                 **KW), seed=3)
    params = convert.from_jax(jax.tree.map(np.asarray, jeng.params),
                              jeng._model_cfg(128))
    clouds = [cloud(n, i) for i, n in enumerate(SIZES)]
    rids = [jeng.submit(c) for c in clouds]
    jeng.flush()
    return params, clouds, [np.asarray(jeng.take(r)) for r in rids]


@pytest.mark.parametrize("microbatch", [2, 3])
def test_mesh_serving_equals_one_process_and_the_reference(reference,
                                                           microbatch):
    params, clouds, jax_logits = reference
    kw = dict(KW, microbatch=microbatch)
    want, _ = serve_stream(kw, params, clouds, 2, False)
    ranks = run_ranks(serve_stream, 4, kw, params, clouds, 2, True)
    for rank, (got, stats) in enumerate(ranks):
        assert stats["world_size"] == 4
        assert stats["mesh"] == {"data": 2, "model": 2}
        assert stats["served"] == len(clouds)
        assert all(v == 1 for v in stats["plan_cache"]["traces"].values())
        for g, w, j, c in zip(got, want, jax_logits, clouds):
            assert g.shape == w.shape == (len(c), 6)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-4)


def test_mesh_scene_equals_on_every_rank(reference):
    """A 3000-point room on a (1, 2) mesh: every rank stitches the same
    logits as one process."""
    params = reference[0]
    coords, _ = synthetic.scene(0, 3000)
    kw = dict(tile_points=1024, halo=0.1, th=64, microbatch=2)
    want = segment_scene(kw, params, coords, None)
    for got in run_ranks(segment_scene, 2, kw, params, coords, 2):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
