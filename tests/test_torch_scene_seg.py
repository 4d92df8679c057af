"""The port's ``SceneEngine.infer`` against the JAX package's, on the CPU.

Both engines segment the same numpy scene (the JAX package's
``synthetic.scene``) with the same weights (the JAX engine's, carried over
by ``repro_torch.convert``): the single-SA-stage ``scene_seg`` model at
halo=0, and the two-stage model with halos of tests/test_scene.py's
multistage case.  The stitched logits must agree within 1e-4, the bar
tests/test_torch_serve.py holds the two serving engines to; the tilings
are equal (tests/test_torch_scene.py), so this holds the port's stream,
drain and stitch against the reference's actual output, not against the
whole-scene equality the reference's own §10 test asserts (ROADMAP C).
The multistage case is in tests/test_torch_scene_halo.py (one JAX engine
each, so the two run on two workers).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scene as jscene  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro_torch import convert, scene  # noqa: E402
from repro_torch.models import pnn  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


def hold_scene_against_jax(n, seed, kw, stages, fp_widths):
    """``stages``: (rate, radius, nsample, widths) tuples, made into each
    package's ``SAStage``."""
    pts, _ = jsynthetic.scene(seed, n, objects=4)
    jeng = jscene.SceneEngine(jscene.SceneConfig(
        impl="xla", stages=tuple(jpnn.SAStage(*s) for s in stages),
        fp_widths=fp_widths, **kw))
    want, jplan = jeng.infer(pts)

    cfg = scene.SceneConfig(stages=tuple(pnn.SAStage(*s) for s in stages),
                            fp_widths=fp_widths, **kw)
    model = convert.from_jax(
        jax.tree.map(np.asarray, jeng.params),
        pnn.PNNConfig(task="seg", stages=cfg.stages, fp_widths=fp_widths))
    eng = scene.SceneEngine(cfg, params=model, device="cpu")
    got, plan = eng.infer(torch.from_numpy(pts))
    assert plan.num_tiles == jplan.num_tiles >= 2
    assert got.shape == (n, cfg.num_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert not eng.engine.results                    # every result drained
    assert eng.stats()["served"] == plan.num_tiles
    return plan


def test_single_stage_scene_matches_jax():
    ref = jpnn.scene_seg(n=2048, th=64, widths=(16, 16), fp=(16, 16))
    stages = [(s.rate, s.radius, s.nsample, s.widths) for s in ref.stages]
    plan = hold_scene_against_jax(
        2048, 8, dict(tile_points=512, halo=0.0, th=64, microbatch=2),
        stages, ref.fp_widths)
    assert plan.halo_points == 0
