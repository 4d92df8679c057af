"""The port's PNN forward against the JAX package, with the same weights.

JAX weights (``repro.models.pnn.init``) are carried over by
``repro_torch.convert``; two clouds from the repo's generators go through
the port as one batch and through JAX one at a time (``impl="xla"``).
Logits must agree within 1e-4, the bar tests/test_point_impls.py sets
between the JAX package's own two backends.  Classification is held here,
segmentation in tests/test_torch_pnn_seg.py (one JAX compile per case, so
the two halves run on two workers).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import pnn  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

VARIANTS = ["pointnet2", "pointnext", "pointvector"]


def configs(variant, task):
    n, th = (256, 32) if task == "cls" else (384, 64)
    kw = dict(variant=variant, task=task, n_points=n, point_ops="bppo",
              th=th)
    return jpnn.PNNConfig(impl="xla", **kw), pnn.PNNConfig(**kw)


def numpy_params(params):
    return jax.tree.map(np.asarray, params)


def hold_apply_against_jax(variant, task):
    jcfg, cfg = configs(variant, task)
    jparams = jpnn.init(jax.random.PRNGKey(1), jcfg)
    model = convert.from_jax(numpy_params(jparams), cfg)
    batch = (synthetic.classification_batch if task == "cls"
             else synthetic.segmentation_batch)
    pts = np.array(batch(0, 3, 2, cfg.n_points)[0])
    valid = np.ones(pts.shape[:2], bool)
    valid[1, -40:] = False                     # a padded tail on cloud 1
    fwd = jax.jit(lambda c, v: jpnn.apply(jparams, jcfg, c, valid=v))
    want = np.stack([np.asarray(fwd(pts[i], valid[i])) for i in range(2)])
    with torch.no_grad():
        got = pnn.apply(model, cfg, torch.from_numpy(pts),
                        valid=torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cls_apply_matches_jax(variant):
    hold_apply_against_jax(variant, "cls")


def test_convert_checks_the_tree():
    jcfg, cfg = configs("pointnext", "cls")
    params = numpy_params(jpnn.init(jax.random.PRNGKey(0), jcfg))
    model = convert.from_jax(params, cfg)
    w = params["stages"][0]["mlp"][0]["dense"]["w"]
    assert torch.equal(model.stages[0].mlp[0].dense.w,
                       torch.from_numpy(np.array(w)))
    assert w.shape == (6, 32)                  # (din, dout), not transposed
    params["stages"][0].pop("res")
    with pytest.raises(ValueError, match="not in the JAX tree"):
        convert.from_jax(params, cfg)
    with pytest.raises(ValueError, match="entries"):
        convert.from_jax(params, dataclasses.replace(cfg, head_widths=(8, 8)))


def test_init_is_seeded_and_shaped_like_jax():
    cfg = configs("pointvector", "seg")[1]
    a = pnn.init(cfg, torch.Generator().manual_seed(3))
    b = pnn.init(cfg, torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    jcfg = configs("pointvector", "seg")[0]
    leaves = jax.tree.leaves(jax.eval_shape(
        lambda: jpnn.init(jax.random.PRNGKey(0), jcfg)))
    assert sum(x.size for x in leaves) == sum(p.numel()
                                              for p in a.parameters())


def test_layer_norm_is_population_variance():
    ln = pnn.LayerNorm(4)
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0]])
    mu, var = 3.0, np.mean((np.array([1, 2, 3, 6]) - 3.0) ** 2)
    want = (np.array([1, 2, 3, 6]) - mu) / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(ln(x).detach().numpy()[0], want, rtol=1e-6)


def test_global_point_ops_not_ported():
    """The presets' default ``point_ops="global"`` runs (it is ported now;
    tests/test_torch_pnn_global.py holds it against JAX); a name that is
    neither kind of point op is refused."""
    cfg = pnn.pointnet2_cls(n=64)
    assert cfg.point_ops == "global"
    pts = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (1, 64, 3)).astype(np.float32))
    with torch.no_grad():
        out = pnn.apply(pnn.init(cfg), cfg, pts)
    assert out.shape == (1, 6) and bool(torch.isfinite(out).all())
    bad = dataclasses.replace(cfg, point_ops="octree")
    with pytest.raises(ValueError, match="point_ops"):
        pnn.apply(pnn.init(bad), bad, pts)


def test_presets_mirror_jax():
    for name in ("pointnet2_cls", "pointnext_cls", "pointnet2_seg",
                 "pointnext_seg", "pointvector_seg"):
        a = getattr(pnn, name)(n=512, point_ops="bppo")
        b = getattr(jpnn, name)(n=512, point_ops="bppo")
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name) or \
                repr(getattr(a, f.name)) == repr(getattr(b, f.name)), f.name
    s = pnn.scene_seg(n=2048)
    assert len(s.stages) == 1 and s.fp_widths == ((64, 64),)
    assert s.stage_sizes() == jpnn.scene_seg(n=2048).stage_sizes()
