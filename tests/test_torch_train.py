"""The port's training substrate against the JAX package, on the CPU.

Mirrors tests/test_train_infra.py for the optimizer, checkpoints, loop and
monitor, and holds the port to the JAX package where the two must agree:
AdamW steps within 1e-6 of ``repro.train.optimizer.update``; checkpoints
of either package restore exactly into the other; the synthetic batches
have JAX's shapes and label ranges.  A short CPU fit of ``pointnet2_seg``
runs end to end.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert, device  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import pnn  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop as loop_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402
from repro_torch.train.monitor import HeartbeatFile, StepMonitor  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

OPT_TOL = 1e-6


# ---------------------------------------------------------------------------
# Optimizer.
# ---------------------------------------------------------------------------

def test_adamw_matches_jax_over_three_steps():
    """Warmup, cosine, clipping (the first gradient is far above the clip
    norm) and decay on matrices only, on the same gradients."""
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "g": (5,)}
    init = {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (30.0, 0.1, 1.0)]
    cfg = dict(lr=0.05, warmup=2, total_steps=5, weight_decay=0.1,
               clip_norm=1.0)

    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jp)
    p = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = opt_lib.init(p)
    for g in grads:
        jp, jstate, jm = jopt.update(jopt.OptConfig(**cfg),
                                     {k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
        p, state, m = opt_lib.update(opt_lib.OptConfig(**cfg),
                                     {k: torch.from_numpy(v)
                                      for k, v in g.items()}, state, p)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        for k in shapes:
            for got, want in ((p[k], jp[k]), (state["m"][k], jstate["m"][k]),
                              (state["v"][k], jstate["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=OPT_TOL, atol=OPT_TOL,
                                           err_msg=k)
    assert state["step"] == int(jstate["step"]) == 3


def test_schedule_reads_the_one_based_step():
    cfg = opt_lib.OptConfig(lr=1.0, warmup=10, total_steps=100)
    jcfg = jopt.OptConfig(lr=1.0, warmup=10, total_steps=100)
    for s in (1, 5, 10, 55, 100):
        assert opt_lib.schedule(cfg, s) == pytest.approx(
            float(jopt.schedule(jcfg, jnp.int32(s))), rel=1e-6)
    assert opt_lib.schedule(cfg, 5) == pytest.approx(0.5)


def test_quadratic_convergence():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = opt_lib.OptConfig(lr=0.2, warmup=0, total_steps=200,
                            weight_decay=0.0)
    state = opt_lib.init(params)
    for _ in range(200):
        params, state, _ = opt_lib.update(cfg, {"w": 2 * params["w"]}, state,
                                          params)
    assert float(params["w"].abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6).reshape(2, 3),
                "b": {"c": torch.ones(4, dtype=torch.bfloat16)}, "s": 7}
        ckpt.save(str(tmp_path), 7, tree, extra={"next_step": 8})
        assert ckpt.latest_step(str(tmp_path)) == 7
        restored, manifest = ckpt.restore(str(tmp_path), 7, tree)
        assert manifest["extra"]["next_step"] == 8
        assert torch.equal(restored["a"], tree["a"])
        assert restored["b"]["c"].dtype == torch.bfloat16
        assert restored["s"] == 7
        assert sorted(os.listdir(tmp_path)) == ["step_00000007"]

    def test_gc_keeps_recent(self, tmp_path):
        for s in (1, 2, 3, 4, 5):
            ckpt.save(str(tmp_path), s, {"x": torch.ones(2)}, keep=2)
        assert ckpt.all_steps(str(tmp_path)) == [4, 5]

    def test_shape_mismatch_detected(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(str(tmp_path), 1, {"x": torch.ones(3)})
        with pytest.raises(KeyError, match="missing"):
            ckpt.restore(str(tmp_path), 1, {"y": torch.ones(2)})

    def test_async_checkpointer(self, tmp_path):
        saver = ckpt.AsyncCheckpointer(str(tmp_path))
        x = torch.ones(2)
        saver.save(3, {"x": x})
        x.add_(1)                 # an in-place update after the hand-off
        saver.wait()
        assert ckpt.latest_step(str(tmp_path)) == 3
        restored, _ = ckpt.restore(str(tmp_path), 3, {"x": x})
        assert torch.equal(restored["x"], torch.ones(2))


def trained_jax_state(cfg):
    """A JAX training state after one AdamW step (moments non-zero)."""
    params = jpnn.init(jax.random.PRNGKey(2), cfg)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01), params)
    params, state, _ = jopt.update(jopt.OptConfig(), grads,
                                   jopt.init(params), params)
    return {"params": params, "opt": state}


def port_state(cfg):
    model = pnn.init(cfg, torch.Generator().manual_seed(5))
    params = train.param_dict(model)
    return {"params": params, "opt": opt_lib.init(params)}


def flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jcfg = jpnn.pointnet2_seg(n=256, point_ops="bppo", th=64)
    cfg = pnn.pointnet2_seg(n=256, point_ops="bppo", th=64)
    jstate = trained_jax_state(jcfg)
    jckpt.save(str(tmp_path), 4, jstate, extra={"next_step": 5})
    state, manifest = ckpt.restore(str(tmp_path), 4, port_state(cfg))
    assert manifest["extra"] == {"next_step": 5}
    want = flat_jax(jstate)
    got = {f"params/{k}": v for k, v in state["params"].items()}
    got.update({f"opt/{m}/{k}": v for m in ("m", "v")
                for k, v in state["opt"][m].items()})
    assert sorted(got) == sorted(k for k in want if k != "opt/step")
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert state["opt"]["step"] == 1
    # The weights carry over as convert.from_jax carries them.
    model = convert.from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg)
    for k, p in train.param_dict(model).items():
        assert torch.equal(p, state["params"][k]), k


def test_port_checkpoint_restores_into_jax(tmp_path):
    jcfg = jpnn.pointnet2_cls(n=192, point_ops="bppo", th=32)
    cfg = pnn.pointnet2_cls(n=192, point_ops="bppo", th=32)
    state = port_state(cfg)
    state["opt"]["step"] = 9
    for m in state["opt"]["m"].values():
        m.fill_(0.25)
    ckpt.save(str(tmp_path), 9, state)
    jstate, _ = jckpt.restore(str(tmp_path), 9, trained_jax_state(jcfg))
    got = flat_jax(jstate)
    assert int(got.pop("opt/step")) == 9
    for k, v in got.items():
        part, name = k.split("/", 1)
        if part == "params":
            want = state["params"][name]
        else:
            which, name = name.split("/", 1)
            want = state["opt"][which][name]
        np.testing.assert_array_equal(v, want.detach().numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# Loop and monitor.
# ---------------------------------------------------------------------------

TOY_OPT = opt_lib.OptConfig(lr=0.1, warmup=0, weight_decay=0.0)


def toy_problem():
    target = torch.from_numpy(
        np.random.default_rng(0).normal(0, 1, (8,)).astype(np.float32))

    def init_params():
        return {"w": torch.zeros(8)}

    def next_batch(step):
        return target

    def train_step(params, opt_state, batch, return_grads=False):
        grads = {"w": 2 * (params["w"] - batch)}
        loss = ((params["w"] - batch) ** 2).sum()
        if return_grads:
            return grads, {"loss": loss}
        params, opt_state, m = opt_lib.update(TOY_OPT, grads, opt_state,
                                              params)
        return params, opt_state, {"loss": loss, **m}

    return init_params, train_step, next_batch, target


class TestLoop:
    def test_trains_and_checkpoints(self, tmp_path):
        init_params, train_step, next_batch, _ = toy_problem()
        cfg = loop_lib.LoopConfig(total_steps=60, ckpt_dir=str(tmp_path),
                                  ckpt_every=20, log_every=1000)
        _, _, info = loop_lib.run(cfg, init_params=init_params,
                                  train_step=train_step,
                                  next_batch=next_batch, opt_cfg=TOY_OPT)
        assert info["history"][-1]["loss"] < info["history"][0]["loss"]
        assert ckpt.latest_step(str(tmp_path)) == 60

    def test_crash_restart_resumes(self, tmp_path):
        init_params, train_step, next_batch, target = toy_problem()
        cfg = loop_lib.LoopConfig(total_steps=50, ckpt_dir=str(tmp_path),
                                  ckpt_every=10, log_every=1000)
        with pytest.raises(RuntimeError, match="injected failure"):
            loop_lib.run(cfg, init_params=init_params, train_step=train_step,
                         next_batch=next_batch, fail_at=35, opt_cfg=TOY_OPT)
        # restart: resumes from step 31 (last checkpoint at 30), finishes
        params, state, info = loop_lib.run(
            cfg, init_params=init_params, train_step=train_step,
            next_batch=next_batch, opt_cfg=TOY_OPT)
        steps_run = [h["step"] for h in info["history"]]
        assert steps_run[0] == 31, "did not resume from checkpoint"
        assert steps_run[-1] == 49
        assert state["step"] == 50
        assert float((params["w"] - target).abs().max()) < 0.15
        assert info["history"][-1]["loss"] < info["history"][0]["loss"]

    def test_grad_compression_is_not_ported(self):
        """Compression is ported now (``repro_torch.dist.compression``): an
        unknown method raises ``ValueError`` naming ``METHODS``, as the
        reference's codec does."""
        init_params, train_step, next_batch, _ = toy_problem()
        with pytest.raises(ValueError, match=r"unknown compression method "
                           r"'fp4'; have \('bf16', 'int8'\)"):
            loop_lib.run(loop_lib.LoopConfig(total_steps=1,
                                             grad_compression="fp4"),
                         init_params=init_params, train_step=train_step,
                         next_batch=next_batch, log=lambda *_: None)

    @pytest.mark.parametrize("method", ["bf16", "int8"])
    def test_error_feedback_trains_and_repeats(self, method):
        """The error-feedback branch reaches the optimum, and a second run
        repeats the first exactly: the stream is keyed by (seed, step)."""
        init_params, train_step, next_batch, target = toy_problem()
        cfg = loop_lib.LoopConfig(total_steps=60, log_every=1000,
                                  grad_compression=method, seed=3)
        params, state, info = loop_lib.run(
            cfg, init_params=init_params, train_step=train_step,
            next_batch=next_batch, opt_cfg=TOY_OPT, log=lambda *_: None)
        assert state["step"] == 60
        assert float((params["w"] - target).abs().max()) < 0.15
        assert info["history"][-1]["loss"] < info["history"][0]["loss"]
        again, _, _ = loop_lib.run(
            cfg, init_params=init_params, train_step=train_step,
            next_batch=next_batch, opt_cfg=TOY_OPT, log=lambda *_: None)
        assert torch.equal(again["w"], params["w"])


class TestMonitor:
    def test_straggler_detection(self):
        mon = StepMonitor(z_thresh=4.0)
        for i in range(20):
            assert not mon.record(i, 0.1 + 0.001 * (i % 3))
        assert mon.record(20, 1.0)  # 10x step time -> straggler
        assert mon.summary()["stragglers"] == 1

    def test_heartbeat(self, tmp_path):
        hb = HeartbeatFile(str(tmp_path / "hb.json"), every=0.0)
        hb.beat(5)
        assert HeartbeatFile.is_alive(str(tmp_path / "hb.json"))
        assert not HeartbeatFile.is_alive(str(tmp_path / "missing.json"))


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cls", "seg"])
def test_synthetic_batches_match_jax_shapes(kind):
    if kind == "cls":
        pts, labels = synthetic.classification_batch(3, 7, 4, 100)
        jpts, jlabels = jsynthetic.classification_batch(3, 7, 4, 100)
    else:
        pts, labels = synthetic.segmentation_batch(3, 7, 4, 100)
        jpts, jlabels = jsynthetic.segmentation_batch(3, 7, 4, 100)
    assert tuple(pts.shape) == jpts.shape and pts.dtype == torch.float32
    assert tuple(labels.shape) == jlabels.shape
    assert int(labels.min()) >= 0 and int(labels.max()) < synthetic.NUM_SHAPES
    assert int(jlabels.max()) < jsynthetic.NUM_SHAPES == synthetic.NUM_SHAPES
    assert torch.isfinite(pts).all()
    # Extents as JAX's: unit shapes scaled by at most 1.3, placed within
    # +-2.5 per axis for a scene.
    reach = float(np.abs(np.asarray(jpts)).max())
    assert float(pts.abs().max()) < (2.2 if kind == "cls" else 4.8)
    assert reach < (2.2 if kind == "cls" else 4.8)


def test_synthetic_stream_is_a_function_of_seed_and_step():
    a = synthetic.segmentation_batch(0, 5, 2, 300)
    b = synthetic.segmentation_batch(0, 5, 2, 300)
    c = synthetic.segmentation_batch(0, 6, 2, 300)
    d = synthetic.segmentation_batch(1, 5, 2, 300)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    # 300 = 3 parts of 100: each part holds one label
    lab = a[1].reshape(2, 3, 100)
    assert (lab == lab[..., :1]).all()
    pts, lab = synthetic.segmentation_batch(0, 5, 2, 301)   # padded tail
    assert torch.equal(pts[:, 300], pts[:, 0]) and torch.equal(lab[:, 300],
                                                                lab[:, 0])


# ---------------------------------------------------------------------------
# The trainer.
# ---------------------------------------------------------------------------

def test_cpu_fit_pointnet2_seg(tmp_path):
    cfg = train.TrainConfig(preset="pointnet2_seg", n_points=256, th=64,
                            batch=2, steps=3, device="cpu",
                            ckpt_dir=str(tmp_path))
    model, state, info = train.fit(cfg, log=lambda *_: None)
    losses = [h["loss"] for h in info["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert state["step"] == 3 and ckpt.latest_step(str(tmp_path)) == 3
    assert next(model.parameters()).device.type == "cpu"
    # a second fit restores the final checkpoint and has nothing to do
    again = pnn.init(train.model_config(cfg))
    _, state2, info2 = train.fit(cfg, params=again, log=lambda *_: None)
    assert info2["history"] == [] and state2["step"] == 3
    for k, p in train.param_dict(model).items():
        assert torch.equal(p, train.param_dict(again)[k]), k


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.fit(train.TrainConfig(steps=1), log=lambda *_: None)
    assert device.resolve_device("cpu").type == "cpu"
