"""Compressed fine-tune steps of the port against the JAX package's, on the
CPU, from the same weights (``convert.from_jax``) and batches, with bf16
and with int8 given the reference's own uniforms:

* one step by hand, grads (``return_grads=True``) -> error feedback ->
  AdamW: the port's error feedback on the reference's own gradients gives
  the reference's decompressed gradients and residual (bf16 bit for bit,
  int8 within 1e-7); the port's decompressed gradients from its own
  backward lie within ``DEC_TOL`` relative L2 of the reference's; the
  parameters after AdamW within ``STEP_TOL``;
* two steps of each package's ``loop.run``: the gradients that each loop
  hands AdamW, and the parameters after, by the same rules, so the
  residual's carry and the loop's wiring (the key (seed, step), the
  optimizer config) are held as well;
* both loops on gradients that the two packages share exactly (a train
  step that returns its batch as the gradient), three steps: what each
  loop hands AdamW agrees bit for bit (bf16) or within 1e-7 (int8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import compression as jcomp  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import pnn as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.dist import compression  # noqa: E402
from repro_torch.models import pnn  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402
from test_torch_compression import (INT8_EF_TOL, bits,  # noqa: E402
                                    feed_uniforms, leaves)

jax.config.update("jax_platform_name", "cpu")

STEP_TOL = 1e-4
# The two backwards sum float32 in different orders, so the raw gradients
# differ in their last bits and a few elements round (bf16) or draw
# (int8) to the neighbouring code: a small share of elements off by one
# quantum of their tensor.
DEC_TOL = 1e-3
SEED = 3
OPT = dict(lr=3e-3, warmup=0, total_steps=10, weight_decay=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_paths(tree) -> list:
    return ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def flat(tree) -> dict:
    return dict(zip(flat_paths(tree), map(np.asarray, jax.tree.leaves(tree))))


def step_uniforms(tree, seed: int, steps: int) -> dict:
    """{step: {path: the uniforms the reference's ``loop.run`` draws for
    that leaf at that step}}."""
    out = {}
    for s in range(steps):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), s),
            len(flat_paths(tree)))
        out[s] = {p: np.asarray(jax.random.uniform(k, leaf.shape))
                  for p, k, leaf in zip(flat_paths(tree), keys,
                                        jax.tree.leaves(tree))}
    return out


def feed_step_uniforms(monkeypatch, names: list, u: dict, seed: int):
    """Make the port's leaf ``i`` (of ``names``) at step ``s`` draw
    ``u[s][names[i]]``, and check that the loop keys it (seed, s, i)."""
    def uniform(key, shape, device):
        assert len(key) == 3 and key[0] == seed, key
        got = torch.from_numpy(u[key[1]][names[key[2]]].copy()).to(device)
        assert tuple(got.shape) == tuple(shape)
        return got
    monkeypatch.setattr(compression, "uniform", uniform)


def spy_updates(monkeypatch, module, seen: list, to_dict):
    """Record (as ``to_dict(grads)``) the gradients each call of
    ``module.update`` receives, then run it."""
    real = module.update

    def update(cfg, grads, state, params, **kw):
        seen.append(to_dict(grads))
        return real(cfg, grads, state, params, **kw)
    monkeypatch.setattr(module, "update", update)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def hold_exact(method, got: dict, want: dict):
    """The port's EF outputs against the reference's on the same input:
    bf16 bit for bit, int8 within ``INT8_EF_TOL``."""
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        if method == "bf16":
            np.testing.assert_array_equal(bits(g), bits(want[k]), err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], rtol=INT8_EF_TOL,
                                       atol=INT8_EF_TOL, err_msg=k)


def hold_close(got: dict, want: dict, tol: float, what: str):
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        rel = rel_l2(g, want[k])
        assert rel <= tol, (what, k, rel)


def model_and_batches(steps: int):
    n, th = 384, 64
    jcfg = jpnn.pointnet2_seg(n=n, point_ops="bppo", th=th, impl="xla")
    cfg = pnn.pointnet2_seg(n=n, point_ops="bppo", th=th)
    jparams = jpnn.init(jax.random.PRNGKey(1), jcfg)
    model = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg)
    batches, jbatches = [], []
    for s in range(steps):
        pts, labels = synthetic.segmentation_batch(0, s, 2, n)
        batches.append({"points": pts, "labels": labels})
        jbatches.append({"points": jnp.asarray(pts.numpy()),
                         "labels": jnp.asarray(labels.numpy()
                                               .astype(np.int32))})
    return jcfg, cfg, jparams, model, batches, jbatches


def torch_dict(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compressed_train_step_matches_the_reference(method, monkeypatch):
    """grads (``return_grads=True``) -> error feedback -> AdamW, the
    reference's ``loop.run`` step, from the same weights and batch."""
    jcfg, cfg, jparams, model, batches, jbatches = model_and_batches(1)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)

    jstep = jtrain.make_train_step(jcfg, jopt.OptConfig(**OPT))
    jraw, jm = jstep(jparams, None, jbatches[0], return_grads=True)
    jdec, jres = jcomp.apply_error_feedback(
        jraw, jcomp.init_residual(jparams), method, key)
    jparams, _, _ = jopt.update(jopt.OptConfig(**OPT), jdec,
                                jopt.init(jparams), jparams)

    params = train.param_dict(model)
    if method == "int8":
        feed_uniforms(monkeypatch, list(params),
                      step_uniforms(jraw, 0, 1)[0])
    # the port's error feedback on the reference's own gradients
    fed = {k: torch.from_numpy(flat(jraw)[k].copy()) for k in params}
    dec, res = compression.apply_error_feedback(
        fed, compression.init_residual(fed), method, (0, 0))
    hold_exact(method, torch_dict(dec), flat(jdec))
    hold_exact(method, torch_dict(res), flat(jres))

    step = train.make_train_step(model, cfg, opt_lib.OptConfig(**OPT))
    grads, m = step(params, None, batches[0], return_grads=True)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    grads, _ = compression.apply_error_feedback(
        grads, compression.init_residual(params), method, (0, 0))
    hold_close(torch_dict(grads), flat(jdec), DEC_TOL, "decompressed")
    state = opt_lib.init(params)
    opt_lib.update(opt_lib.OptConfig(**OPT), grads, state, params)
    hold_close(torch_dict(params), flat(jparams), STEP_TOL, "parameters")


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_loop_runs_error_feedback_as_the_reference(method, monkeypatch):
    """Two steps of each package's ``loop.run`` with compression, from the
    same weights and batches: the gradients handed to AdamW at each step
    and the parameters after."""
    steps = 2
    jcfg, cfg, jparams, model, batches, jbatches = model_and_batches(steps)
    lcfg = dict(total_steps=steps, grad_compression=method, seed=SEED,
                log_every=100)

    jseen = []
    spy_updates(monkeypatch, jopt, jseen, flat)
    jout, _, jinfo = jloop.run(
        jloop.LoopConfig(**lcfg), init_params=lambda: jparams,
        train_step=jtrain.make_train_step(jcfg, jopt.OptConfig(**OPT)),
        next_batch=lambda s: jbatches[s], opt_cfg=jopt.OptConfig(**OPT),
        log=lambda *_: None)

    params = train.param_dict(model)
    if method == "int8":
        feed_step_uniforms(monkeypatch, list(params),
                           step_uniforms(jparams, SEED, steps), SEED)
    seen = []
    spy_updates(monkeypatch, opt_lib, seen, torch_dict)
    out, state, info = loop.run(
        loop.LoopConfig(**lcfg), init_params=lambda: params,
        train_step=train.make_train_step(model, cfg,
                                         opt_lib.OptConfig(**OPT)),
        next_batch=lambda s: batches[s], opt_cfg=opt_lib.OptConfig(**OPT),
        log=lambda *_: None)

    assert len(seen) == len(jseen) == steps and state["step"] == steps
    for s in range(steps):
        hold_close(seen[s], jseen[s], DEC_TOL, f"step {s} decompressed")
        assert info["history"][s]["loss"] == pytest.approx(
            jinfo["history"][s]["loss"], rel=1e-5)
    hold_close(torch_dict(out), flat(jout), STEP_TOL, "parameters")


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_loop_error_feedback_is_exact_on_shared_gradients(method,
                                                          monkeypatch):
    """Both loops fed the same raw gradients (the batch of each step):
    the gradients each hands AdamW agree bit for bit (bf16) or within
    1e-7 (int8) at every step, the residual carried between steps."""
    steps = 3
    grads = [leaves(s) for s in range(steps)]
    order = ["c", "a/w", "b"]                   # not the reference's order
    lcfg = dict(total_steps=steps, grad_compression=method, seed=SEED,
                log_every=100)

    def jstep(params, opt_state, batch, return_grads=False):
        assert return_grads
        return ({k: jnp.asarray(v) for k, v in batch.items()},
                {"loss": jnp.asarray(0.0)})

    jseen = []
    spy_updates(monkeypatch, jopt, jseen, flat)
    jloop.run(jloop.LoopConfig(**lcfg),
              init_params=lambda: {k: jnp.zeros(v.shape)
                                   for k, v in grads[0].items()},
              train_step=jstep, next_batch=lambda s: grads[s],
              opt_cfg=jopt.OptConfig(**OPT), log=lambda *_: None)

    def step(params, opt_state, batch, return_grads=False):
        assert return_grads
        return ({k: torch.from_numpy(batch[k].copy()) for k in order},
                {"loss": torch.tensor(0.0)})

    if method == "int8":
        feed_step_uniforms(monkeypatch, order,
                           step_uniforms(grads[0], SEED, steps), SEED)
    seen = []
    spy_updates(monkeypatch, opt_lib, seen, torch_dict)
    loop.run(loop.LoopConfig(**lcfg),
             init_params=lambda: {k: torch.zeros(grads[0][k].shape)
                                  for k in order},
             train_step=step, next_batch=lambda s: grads[s],
             opt_cfg=opt_lib.OptConfig(**OPT), log=lambda *_: None)

    assert len(seen) == len(jseen) == steps
    for s in range(steps):
        assert list(seen[s]) == order
        hold_exact(method, seen[s], jseen[s])
    if method == "bf16":
        # the carry shows: step 1 without the residual codes differently
        g1 = {k: torch.from_numpy(grads[1][k].copy()) for k in order}
        fresh, _ = compression.apply_error_feedback(
            g1, compression.init_residual(g1), method, (SEED, 1))
        assert any(not np.array_equal(bits(seen[1][k]), bits(fresh[k]))
                   for k in order)
