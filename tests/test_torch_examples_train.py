"""The port's PointNet++ trainer (``repro_torch.examples.train_pointnet``)
against a reference step built as ``examples/train_pointnet.py`` builds
it, on the CPU, at ``--steps 4 --batch 2 --n-points 128 --th 32``, for
both point ops (``global`` in tests/test_torch_examples_train_global.py,
so that the two run on two workers).

Both start from the reference's initial parameters (carried over by
``repro_torch.convert``) and take the same numpy batches (the reference's
synthetic stream).  Every step's loss is within ``LOSS_TOL`` of the
reference's; the final accuracies, over the same eval clouds, differ by
at most one cloud.  A run checkpointed at step 2 and rerun to step 4
resumes at the checkpoint's ``next_step`` and takes the uninterrupted
run's steps bit for bit (the schedule is still in its warmup, so the
total does not change it); a rerun at step 4 resumes with nothing left
to train and ends with the same parameters and accuracy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import train_pointnet  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOSS_TOL = 1e-4
ARGV = ["--steps", "4", "--batch", "2", "--n-points", "128", "--th", "32",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_run(args):
    """The reference example's step and eval (examples/train_pointnet.py
    lines 36-66), from PRNGKey(seed): initial params, every step's loss,
    the final eval accuracy."""
    cfg = jpnn.pointnet2_cls(n=args.n_points, point_ops=args.point_ops,
                             th=args.th)
    params = jpnn.init(jax.random.PRNGKey(args.seed), cfg)
    init = jax.tree.map(np.asarray, params)
    opt_cfg = jopt.OptConfig(lr=2e-3, warmup=20, total_steps=args.steps,
                             weight_decay=1e-4)
    opt_state = jopt.init(params)

    @jax.jit
    def train_step(params, opt_state, pts, labels):
        def loss_f(p):
            logits = jax.vmap(lambda c: jpnn.apply(p, cfg, c))(pts)
            ll = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(ll, labels[:, None], 1))

        loss, grads = jax.value_and_grad(loss_f)(params)
        params, opt_state, _ = jopt.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, loss

    @jax.jit
    def eval_acc(params, pts, labels):
        logits = jax.vmap(lambda c: jpnn.apply(params, cfg, c))(pts)
        return jnp.mean(jnp.argmax(logits, -1) == labels)

    losses = []
    for step in range(args.steps):
        params, opt_state, loss = train_step(params, opt_state,
                                             *batch(args.seed, step, args))
        losses.append(float(loss))
    acc = np.mean([float(eval_acc(params, *batch(args.seed + 999, s, args)))
                   for s in range(train_pointnet.FINAL_EVAL_BATCHES)])
    return cfg, init, losses, float(acc)


def batch(seed, step, args):
    pts, labels = jsynthetic.classification_batch(seed, step, args.batch,
                                                  args.n_points)
    return np.array(pts), np.array(labels)


def port_run(args, init, jcfg, steps, ckpt=""):
    mcfg = train_pointnet.config(args)
    model = convert.from_jax(init, jcfg)

    def batches(seed):
        def get(step):
            pts, labels = batch(seed, step, args)
            return torch.from_numpy(pts), torch.from_numpy(labels).long()
        return get

    out = train_pointnet.train(
        model, mcfg, steps=steps, next_batch=batches(args.seed),
        eval_batch=batches(args.seed + 999), ckpt=ckpt, log=lambda *_: None)
    return model, out


def hold_train_client(point_ops, tmp_path):
    args = train_pointnet.parse(ARGV + ["--point-ops", point_ops])
    jcfg, init, want, want_acc = reference_run(args)
    model, got = port_run(args, init, jcfg, args.steps)
    assert got["start_step"] == 0 and got["resumed_from"] is None
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=LOSS_TOL)
    n_eval = train_pointnet.FINAL_EVAL_BATCHES * args.batch
    assert abs(got["final_accuracy"] - want_acc) <= 1 / n_eval + 1e-9
    assert [r["step"] for r in got["logged"]] == [0]

    ckpt = str(tmp_path / "ckpt")
    _, part = port_run(args, init, jcfg, 2, ckpt)
    assert part["losses"] == got["losses"][:2]
    _, rest = port_run(args, init, jcfg, args.steps, ckpt)
    assert (rest["resumed_from"], rest["start_step"]) == (2, 2)
    assert rest["losses"] == got["losses"][2:]
    again_model, again = port_run(args, init, jcfg, args.steps, ckpt)
    assert (again["resumed_from"], again["start_step"]) == (4, 4)
    assert again["losses"] == []
    assert again["final_accuracy"] == got["final_accuracy"]
    for (name, p), q in zip(model.named_parameters(),
                            again_model.parameters()):
        assert torch.equal(p, q), name


def test_train_client_matches_the_reference_step_bppo(tmp_path):
    hold_train_client("bppo", tmp_path)
