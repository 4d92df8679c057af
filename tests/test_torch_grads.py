"""The port's gradients against the JAX package, on the CPU.

Mirrors tests/test_grads.py: the gather's backward (``kernels.vjp.
Gathering`` around ``scatter_add_blocks``) against ``jax.vjp`` of the JAX
oracle, out-of-range indices and chunking included, within 1e-5; the
scatter-add's plain version against the JAX oracle and, once, the Pallas
kernel in interpret mode; no gradient through the index producers (FPS,
ball query, kNN); and the loss and every parameter's gradient of the PNN
fine-tune loss, port against JAX with the same weights
(``convert.from_jax``), within 1e-4, the bar tests/test_grads.py sets
between the JAX package's two backends (classification here,
segmentation in tests/test_torch_grads_seg.py: one JAX compile each, so
the two run on two workers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import pnn as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import checks, gather, ops, vjp  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
GRAD_TOL = 1e-4


def blocks(seed, nb, bs):
    rng = np.random.default_rng(seed)
    coords = rng.normal(0, 1, (nb, bs, 3)).astype(np.float32)
    nvalid = rng.integers(1, bs + 1, nb)
    return coords, np.arange(bs)[None, :] < nvalid[:, None]


def gather_case(seed=0, nb=3, w=40, m=17, c=9):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (nb, w, c)).astype(np.float32)
    idx = rng.integers(-5, w + 10, (nb, m)).astype(np.int32)   # out both ways
    g = rng.normal(0, 1, (nb, m, c)).astype(np.float32)
    return feats, idx, g


@pytest.mark.parametrize("chunk", [None, 2])
def test_gather_vjp_matches_jax_oracle(chunk):
    feats, idx, g = gather_case()
    want_out, jvjp = jax.vjp(lambda f: ref.gather_blocks(f, jnp.asarray(idx)),
                             jnp.asarray(feats))
    (want,) = jvjp(jnp.asarray(g))
    f = torch.from_numpy(feats).requires_grad_()
    out = ops.gather_blocks(f, torch.from_numpy(idx), chunk=chunk)
    (got,) = torch.autograd.grad(out, f, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dropped = np.ones((3, 40), bool)
    for b in range(3):
        dropped[b, idx[b][(idx[b] >= 0) & (idx[b] < 40)]] = False
    assert (got.numpy()[dropped] == 0).all()   # rows nobody fetched


@pytest.mark.parametrize("nb,w,m,c", [(3, 33, 65, 9), (2, 128, 768, 64),
                                      (4, 200, 65, 128)])
def test_scatter_add_plain_matches_jax_oracle(nb, w, m, c):
    rng = np.random.default_rng(w + m)
    g = rng.normal(0, 1, (nb, m, c)).astype(np.float32)
    idx = rng.integers(-3, w + 3, (nb, m)).astype(np.int32)
    idx[:, ::5] = -1
    idx[0] = w - 1                                   # every row to one slot
    want = ref.scatter_add_blocks(jnp.asarray(g), jnp.asarray(idx), w=w)
    got = gather.scatter_add_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                   w=w)
    assert got.shape == (nb, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_scatter_add_blocks_matches_pallas_interpret():
    feats, idx, g = gather_case(seed=3, nb=2, w=33, m=65, c=9)
    want = jops._gather_grad_blocks(jnp.asarray(g), jnp.asarray(idx), w=33,
                                    impl="pallas", chunk=None)
    got = gather.scatter_add_blocks(torch.from_numpy(g),
                                    torch.from_numpy(idx), w=33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_gather_output_comes_from_the_gathering_node():
    feats, idx, _ = gather_case()
    out = ops.gather_blocks(torch.from_numpy(feats).requires_grad_(),
                            torch.from_numpy(idx))
    assert out.grad_fn is not None
    assert out.grad_fn.__class__.__name__ == "GatheringBackward"
    assert isinstance(out.grad_fn, vjp.Gathering._backward_cls)


def test_index_producers_pass_no_gradient():
    coords, mask = blocks(1, 2, 40)
    c = torch.from_numpy(coords).requires_grad_()
    m = torch.from_numpy(mask)
    _, d2 = ops.knn_blocks(c, c, m, k=3)
    assert not d2.requires_grad
    _, d2, cnt = ops.ball_query_blocks(c, m, c, m, radius=0.7, num=4)
    assert not d2.requires_grad and not cnt.requires_grad
    # A loss that uses FPS's indices differentiates only through the
    # explicit gather at the selected slots, never through the selection.
    idx = ops.fps_blocks(c, m, k=4)
    assert not idx.requires_grad
    picked = torch.gather(c, 1, idx.long()[..., None].expand(2, 4, 3))
    (g,) = torch.autograd.grad(picked.sum(), c)
    want = np.zeros_like(coords)
    for b in range(2):
        for i in idx[b].tolist():
            want[b, i] += 1.0
    np.testing.assert_array_equal(g.numpy(), want)


def test_grad_rule_flags_silent_and_distant_parameters():
    """The card-against-CPU rule of chip_smoke.py and the cuda tests."""
    cpu = {"a": torch.ones(3), "b": torch.full((2, 2), 2.0)}
    near = {"a": torch.ones(3) * (1 + 1e-5), "b": cpu["b"].clone()}
    assert max(checks.hold_grads(near, cpu).values()) < checks.GRAD_REL_TOL
    for bad, match in [({"a": None, "b": cpu["b"]}, "no gradient"),
                       ({"a": torch.zeros(3), "b": cpu["b"]}, "no gradient"),
                       ({"a": torch.ones(3) * 1.01, "b": cpu["b"]},
                        "beyond")]:
        with pytest.raises(AssertionError, match=match):
            checks.hold_grads(bad, cpu)


def jax_grads_by_path(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def hold_grads_against_jax(preset, n, th):
    """Loss and every parameter's gradient of ``train.loss_fn`` against
    ``jax.value_and_grad`` of the JAX trainer's ``loss_fn`` (``impl="xla"``)
    on two clouds, same weights; every parameter must get a gradient."""
    jcfg = jtrain.model_config(jtrain.TrainConfig(
        preset=preset, n_points=n, th=th, impl="xla"))
    cfg = train.model_config(train.TrainConfig(preset=preset, n_points=n,
                                               th=th))
    jparams = jpnn.init(jax.random.PRNGKey(0), jcfg)
    make = (jsynthetic.classification_batch if jcfg.task == "cls"
            else jsynthetic.segmentation_batch)
    pts, labels = (np.array(a) for a in make(0, 0, 2, n))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jcfg, {"points": pts, "labels": labels}),
        has_aux=True))(jparams)

    model = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg)
    params = train.param_dict(model)
    grads, metrics = train.grads_fn(model, cfg)(params, {
        "points": torch.from_numpy(pts),
        "labels": torch.from_numpy(labels.astype(np.int64))})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    want = jax_grads_by_path(jgrads)
    assert sorted(want) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    silent = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    assert not silent, f"parameters with no gradient: {silent}"


def test_cls_loss_and_grads_match_jax():
    hold_grads_against_jax("pointnet2_cls", 192, 32)
