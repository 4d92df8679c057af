"""The port's scene path (``repro_torch.scene``) against the JAX package's
``repro.scene``, on the CPU: tiling, stitching, errors and the generator.

Both tilers cut the same numpy scene (the JAX package's
``synthetic.scene``); every ``Tile`` field and ``overflowed`` must be
equal, exactly.  The port's own generator must not depend on its chunk
size.  The stitched logits of the two ``SceneEngine``s are held against
each other in tests/test_torch_scene_seg.py.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scene as jscene  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import scene  # noqa: E402
from repro_torch.core import bppo, fractal  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import pnn  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hold_plans(got, want):
    assert got.n == want.n and got.tile_points == want.tile_points
    assert got.halo == want.halo and got.strategy == want.strategy
    assert got.overflowed == want.overflowed
    assert got.num_tiles == want.num_tiles
    for a, b in zip(got.tiles, want.tiles):
        assert a.tid == b.tid and a.depth == b.depth and a.dim0 == b.dim0
        for f in ("owned", "halo", "lo", "hi"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"tile {a.tid} {f}")


@pytest.mark.parametrize("n,tile_points,halo,kw", [
    (4096, 512, 0.0, {}),
    (4096, 512, 0.4, dict(max_halo_points=64)),
    (3000, 256, 0.5, dict(halo_window=300)),
])
def test_tiling_matches_jax(n, tile_points, halo, kw):
    pts, _ = jsynthetic.scene(0, n, objects=8)
    want = jscene.tile_scene(pts, tile_points=tile_points, halo=halo, **kw)
    got = scene.tile_scene(pts, tile_points=tile_points, halo=halo, **kw)
    assert got.num_tiles >= 2
    hold_plans(got, want)
    if halo:
        assert got.halo_points > 0
    owned = np.concatenate([t.owned for t in got.tiles])
    assert sorted(owned.tolist()) == list(range(n))        # exact cover


def test_overflowed_tiling_matches_jax():
    pts = np.zeros((1024, 3), np.float32)
    pts[:100] = np.random.default_rng(0).normal(0, 1, (100, 3))
    want = jscene.tile_scene(pts, tile_points=256)
    with pytest.warns(fractal.FractalOverflowWarning):
        got = scene.tile_scene(torch.from_numpy(pts), tile_points=256)
    assert got.overflowed and want.overflowed
    hold_plans(got, want)


def test_stitch_owner_tile_rule():
    """Halo rows carry sentinels; the stitched output must never hold one,
    and a row-count mismatch is loud."""
    pts, _ = jsynthetic.scene(0, 2048, objects=4)
    plan = scene.tile_scene(pts, tile_points=256, halo=0.5,
                            max_halo_points=64)
    assert plan.halo_points > 0
    outputs = {}
    for t in plan.tiles:
        rows = np.full((t.n, 3), float(t.tid), np.float32)
        rows[t.n_owned:] = np.nan                          # halo sentinel
        outputs[t.tid] = rows
        np.testing.assert_array_equal(t.indices[:t.n_owned], t.owned)
    out = scene.stitch(plan, outputs, 3)
    assert np.isfinite(out).all()
    owner = scene.owner_of(plan)
    assert (owner >= 0).all()
    np.testing.assert_array_equal(out[:, 0], owner.astype(np.float32))
    want = jscene.owner_of(jscene.tile_scene(pts, tile_points=256, halo=0.5,
                                             max_halo_points=64))
    np.testing.assert_array_equal(owner, want)
    outputs[plan.tiles[0].tid] = outputs[plan.tiles[0].tid][:-1]
    with pytest.raises(ValueError, match="rows"):
        scene.stitch(plan, outputs, 3)


def test_scene_engine_rejects_tiny_tiles_and_needs_a_device():
    with pytest.raises(ValueError, match="tile_points"):
        scene.SceneEngine(scene.SceneConfig(tile_points=64, th=256),
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            scene.SceneEngine(scene.SceneConfig(tile_points=512, th=64))


def test_scene_engine_fails_fast_on_overflowed_tiling():
    pts = np.zeros((2048, 3), np.float32)
    eng = scene.SceneEngine(scene.SceneConfig(
        tile_points=512, th=64, halo=0.0,
        stages=(pnn.SAStage(0.25, 0.25, 8, (8, 8)),), fp_widths=((8,),)),
        device="cpu")
    with pytest.warns(fractal.FractalOverflowWarning):
        with pytest.raises(fractal.FractalOverflowError,
                           match="tile_points=512"):
            eng.infer(pts)
    assert eng.stats()["served"] == 0                      # nothing ran


def test_scene_generator_is_chunk_invariant():
    p1, l1 = synthetic.scene(0, 3000, chunk=256)
    p2, l2 = synthetic.scene(0, 3000, chunk=3000)
    p3, l3 = synthetic.scene(0, 3000, chunk=1001)
    assert torch.equal(p1, p2) and torch.equal(p1, p3)
    assert torch.equal(l1, l2) and torch.equal(l1, l3)
    assert p1.shape == (3000, 3) and p1.dtype == torch.float32
    assert l1.shape == (3000,) and l1.dtype == torch.int32
    assert set(l1.unique().tolist()) <= set(range(synthetic.NUM_SHAPES))
    assert bool(torch.isfinite(p1).all())
    assert not torch.equal(p1, synthetic.scene(1, 3000)[0])
    # objects follow one another: object 0 holds the first 1500 points
    assert len(set(l1[:1500].tolist())) == 1
    with pytest.raises(ValueError):
        synthetic.scene(0, 0)
    with pytest.raises(ValueError):
        synthetic.scene(0, 10, objects=0)


def test_scene_generator_draws_a_flat_room():
    """The room's shape: offsets within ``extent`` in x and y and 0.35 of
    it in z, shapes scaled by at most 1.2 (plus noise); every shape
    present in a large scene; the noise is a unit normal."""
    pts, labels = synthetic.scene(3, 200_000)
    lo, hi = pts.min(0).values, pts.max(0).values
    assert (hi[:2] <= 6.0 + 2.0).all() and (lo[:2] >= -6.0 - 2.0).all()
    assert hi[2] <= 0.35 * 6.0 + 2.0 and lo[2] >= -0.35 * 6.0 - 2.0
    assert hi[2] - lo[2] < hi[0] - lo[0]                   # flat in z
    assert set(labels.unique().tolist()) == set(range(synthetic.NUM_SHAPES))
    h = torch.arange(100_000)
    z0, z1 = synthetic._normals(synthetic._hash(0, h, 0, 1),
                                synthetic._hash(0, h, 0, 2))
    for z in (z0, z1):
        assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02


@pytest.mark.parametrize("seed,n,tile_points,fits", [(8, 2048, 512, True),
                                                     (3, 4096, 1024, False)])
def test_stitched_scene_against_the_whole_forward(seed, n, tile_points,
                                                  fits):
    """The port's own whole-scene property (the reference's §10 test, run
    on the port): with halo=0 and the single-stage model, stitched
    tile-wise logits equal one whole-scene forward within 1e-4 -- where
    the whole-scene run's sample quota holds its samples.  At seed 3 it
    does not (1026 samples for a quota of 1024, the precondition the
    reference's own test stops at), and the two differ."""
    cfg = pnn.scene_seg(n=n, th=64, widths=(16, 16), fp=(16, 16))
    pts = torch.from_numpy(jsynthetic.scene(seed, n, objects=n // 512)[0])
    part = fractal.partition(pts[None], th=64)
    k_out = int(round(cfg.stages[0].rate * n))
    total = int(bppo.blockwise_fps(part, rate=cfg.stages[0].rate,
                                   k_out=k_out, bs=64).total[0])
    assert (total <= k_out) == fits, (total, k_out)
    model = pnn.init(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        whole = pnn.apply(model, cfg, pts[None])[0].numpy()
    eng = scene.SceneEngine(scene.SceneConfig(
        tile_points=tile_points, halo=0.0, th=64, microbatch=2,
        stages=cfg.stages, fp_widths=cfg.fp_widths), params=model,
        device="cpu")
    out, plan = eng.infer(pts)
    assert plan.num_tiles >= 4
    close = np.isclose(out, whole, rtol=1e-4, atol=1e-4).all(-1)
    assert close.all() == fits
    if not fits:
        assert close.mean() > 0.9          # the truncated quota's points
