"""The port's BPPO forward at room scale against the reference, on the CPU.

The reference's ``synthetic.scene(0, 3000)`` points (extent ~6, so |a|^2
reaches ~36) through ``scene_seg(widths=(16, 16), fp=(16, 16))``, the
single-SA-stage model of the scene path, with the reference's weights
carried over by ``repro_torch.convert``.  At this scale the two sides'
expanded distances |a|^2 + |b|^2 - 2ab round differently by a few ulps,
so a near-tie in a ball-query or interpolation row can go the other way
(ROADMAP C, "Near-ties at room scale"), and the 1e-4 that
tests/test_torch_bppo.py holds on smaller clouds does not apply.  Held:

* the partition (every field) and the block-wise FPS equal exactly;
* ball query: every in-radius count and mask equal exactly, and at most
  ``BQ_ROW_SHARE`` of the rows order or choose a near-tie differently;
* the logits by the serving rule: |difference| <= ``LOGIT_TOL`` on >=
  ``LOGIT_SHARE`` of the points (PERF.md section 2).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro_torch import convert, core  # noqa: E402
from repro_torch.models import pnn  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N = 3000
LOGIT_TOL = 1e-3
LOGIT_SHARE = 0.999
BQ_ROW_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    pts, _ = jsynthetic.scene(0, N)
    jcfg = jpnn.scene_seg(n=N, widths=(16, 16), fp=(16, 16))
    cfg = pnn.scene_seg(n=N, widths=(16, 16), fp=(16, 16))
    assert len(cfg.stages) == len(jcfg.stages) == 1
    params = jax.tree.map(np.asarray, jpnn.init(jax.random.PRNGKey(0), jcfg))
    return np.array(pts), jcfg, cfg, params


def test_scene_scale_plan_matches_the_reference(scene):
    pts, jcfg, cfg, _ = scene
    st, k_out = jcfg.stages[0], jcfg.stage_sizes()[1]

    @jax.jit
    def ref_plan(c):
        part = jcore.partition(c, th=jcfg.th, strategy=jcfg.strategy,
                               on_overflow="silent")
        samp = jcore.blockwise_fps(part, rate=st.rate, k_out=k_out,
                                   bs=jcfg.th)
        nb = jcore.blockwise_ball_query(part, samp, radius=st.radius,
                                        num=st.nsample, w=2 * jcfg.th)
        return part, samp, nb

    jpart, jsamp, jnb = jax.tree.map(np.asarray, ref_plan(pts))
    part = core.partition(torch.from_numpy(pts)[None], th=cfg.th,
                          strategy=cfg.strategy, on_overflow="silent")
    samp = core.blockwise_fps(part, rate=st.rate, k_out=k_out, bs=cfg.th)
    nb = core.blockwise_ball_query(part, samp, radius=st.radius,
                                   num=st.nsample, w=2 * cfg.th)
    for f in dataclasses.fields(part):
        np.testing.assert_array_equal(getattr(part, f.name)[0].numpy(),
                                      getattr(jpart, f.name), err_msg=f.name)
    for f in ("local_idx", "block_mask", "gidx", "quota", "idx", "valid",
              "leaf", "total"):
        np.testing.assert_array_equal(getattr(samp, f)[0].numpy(),
                                      getattr(jsamp, f), err_msg=f)
    np.testing.assert_array_equal(nb.cnt[0].numpy(), jnb.cnt)
    np.testing.assert_array_equal(nb.mask[0].numpy(), jnb.mask)
    rows = (nb.idx[0].numpy() != jnb.idx).any(-1)
    assert rows.mean() <= BQ_ROW_SHARE, int(rows.sum())


def test_scene_scale_logits_by_the_serving_rule(scene):
    pts, jcfg, cfg, params = scene
    want = np.asarray(jax.jit(lambda p, c: jpnn.apply(p, jcfg, c))(
        params, pts))
    model = convert.from_jax(params, cfg)
    with torch.no_grad():
        got = pnn.apply(model, cfg, torch.from_numpy(pts)[None])[0].numpy()
    assert got.shape == want.shape == (N, cfg.num_classes)
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(-1)
    assert (diff <= LOGIT_TOL).mean() >= LOGIT_SHARE, (
        int((diff > LOGIT_TOL).sum()), float(diff.max()))
