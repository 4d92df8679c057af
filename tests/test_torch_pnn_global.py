"""The port's PNN with ``point_ops="global"`` (the O(n^2) baseline of
``core/ref.py``) against the JAX package, with the same weights.

Logits of a classification and a segmentation preset, and the fine-tune
loss with every parameter's gradient, port against JAX (weights carried
over by ``repro_torch.convert``), within 1e-4: the bar
tests/test_point_impls.py and tests/test_grads.py set between the JAX
package's own two backends.  Clouds come from the JAX package's
generators; one cloud has a padded tail, so the global ops see invalid
points.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import pnn as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import pnn  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402
from test_torch_grads import jax_grads_by_path  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset,n", [("pointnext_cls", 160),
                                      ("pointvector_seg", 192)])
def test_global_apply_matches_jax(preset, n):
    jcfg = getattr(jpnn, preset)(n=n, point_ops="global", impl="xla")
    cfg = getattr(pnn, preset)(n=n, point_ops="global")
    jparams = jpnn.init(jax.random.PRNGKey(2), jcfg)
    model = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg)
    batch = (synthetic.classification_batch if cfg.task == "cls"
             else synthetic.segmentation_batch)
    pts = np.array(batch(1, 0, 2, n)[0])
    valid = np.ones(pts.shape[:2], bool)
    valid[1, -30:] = False                     # a padded tail on cloud 1
    fwd = jax.jit(lambda c, v: jpnn.apply(jparams, jcfg, c, valid=v))
    want = np.stack([np.asarray(fwd(pts[i], valid[i])) for i in range(2)])
    with torch.no_grad():
        got = pnn.apply(model, cfg, torch.from_numpy(pts),
                        valid=torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("preset,n", [("pointnet2_cls", 128),
                                      ("pointnet2_seg", 160)])
def test_global_loss_and_grads_match_jax(preset, n):
    jcfg = jtrain.model_config(jtrain.TrainConfig(
        preset=preset, n_points=n, point_ops="global", impl="xla"))
    cfg = train.model_config(train.TrainConfig(preset=preset, n_points=n,
                                               point_ops="global"))
    assert cfg.point_ops == jcfg.point_ops == "global"
    jparams = jpnn.init(jax.random.PRNGKey(0), jcfg)
    make = (synthetic.classification_batch if cfg.task == "cls"
            else synthetic.segmentation_batch)
    pts, labels = (np.array(a) for a in make(0, 0, 2, n))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jcfg, {"points": pts, "labels": labels}),
        has_aux=True))(jparams)

    model = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg)
    grads, metrics = train.grads_fn(model, cfg)(train.param_dict(model), {
        "points": torch.from_numpy(pts),
        "labels": torch.from_numpy(labels.astype(np.int64))})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=TOL, atol=TOL)
    want = jax_grads_by_path(jgrads)
    assert sorted(want) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    silent = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    assert not silent, f"parameters with no gradient: {silent}"
