"""The port's LM training around the step, on the CPU: the Mamba2 repair,
checkpoints across the two packages, crash and resume, and the launcher.

* Mamba2 (``lm/ssm.py``): the intra-chunk decay masked before its exp
  gives the forward of the parent's formula (masked after the exp) bit
  for bit; at ``A_log = 0.5, dt_bias = 1.0`` with chunk 128 (zamba2's) the
  parent's formula overflows and its gradients are not finite, the port's
  are; at the reduced init the block's gradients are the reference's
  within 1e-4 relative L2.
* A checkpoint the port writes (``lm.steps.ckpt_tree``: stacked
  ``params/scan/...``, reps first) restores through the reference's
  ``repro.train.checkpoint`` into its ``{"params", "opt"}`` tree exactly,
  and one the reference writes restores into the port's tensors exactly.
* A run that crashes (``fail_at``) and resumes from its checkpoint ends
  with the uninterrupted run's parameters, moments and losses, bit for
  bit.
* ``launch.train`` on reduced configs (smollm, granite, zamba2, xlstm; and
  int8 compression), its restart, and its refusal without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import ssm as jssm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402
from repro_torch.lm import ssm  # noqa: E402
from repro_torch.lm import steps  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop as loop_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from test_torch_lm_steps import (TOL, batch_of, flat, hold_tree,  # noqa: E402
                                 pair, rel_l2)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Mamba2: the mask before the exp.
# ---------------------------------------------------------------------------

def parent_intra_weights(cb, lac, causal):
    """The parent's (and the reference's) form: the exp over the whole
    (L, L) square, masked after it."""
    decay = torch.exp(lac[:, :, :, None, :] - lac[:, :, None, :, :])
    return torch.where(causal, cb[..., None] * decay, 0.0)


def overflow_block():
    """A (d 64, chunk 128) block at a decay whose cumulative log-decay
    over one chunk passes float32's exp range."""
    cfg = ssm.SSMConfig(d_state=16, expand=2, headdim=16, chunk=128)
    block, _ = ssm.mamba2_init(torch.Generator().manual_seed(0), 64, cfg)
    with torch.no_grad():
        block.A_log.fill_(0.5)
        block.dt_bias.fill_(1.0)
    x = torch.randn((1, 256, 64), generator=torch.Generator().manual_seed(1))
    return block, cfg, x


def block_grads(block, cfg, x):
    x = x.clone().requires_grad_(True)
    y = ssm.mamba2_forward(block, x, d=64, cfg=cfg)
    y.square().sum().backward()
    return y.detach(), x.grad, block.A_log.grad


def test_mamba2_forward_unchanged_and_grads_finite(monkeypatch):
    block, cfg, x = overflow_block()
    y, gx, ga = block_grads(block, cfg, x)
    assert torch.isfinite(y).all()
    assert torch.isfinite(gx).all() and torch.isfinite(ga).all()
    assert all(torch.isfinite(p.grad).all() for p in block.parameters())
    block.zero_grad()
    monkeypatch.setattr(ssm, "_intra_weights", parent_intra_weights)
    y_old, gx_old, ga_old = block_grads(block, cfg, x)
    assert torch.equal(y_old, y)
    assert not (torch.isfinite(gx_old).all() and torch.isfinite(ga_old).all())


def test_mamba2_forward_bits_at_the_reduced_init(monkeypatch):
    cfg = ssm.SSMConfig(d_state=16, expand=2, headdim=16, chunk=16)
    block, _ = ssm.mamba2_init(torch.Generator().manual_seed(2), 64, cfg)
    x = torch.randn((2, 40, 64), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y, st = ssm.mamba2_forward(block, x, d=64, cfg=cfg,
                                   return_state=True)
        monkeypatch.setattr(ssm, "_intra_weights", parent_intra_weights)
        y_old, st_old = ssm.mamba2_forward(block, x, d=64, cfg=cfg,
                                           return_state=True)
    assert torch.equal(y, y_old)
    assert all(torch.equal(st[k], st_old[k]) for k in st)


def test_mamba2_grads_match_reference():
    jcfg = jssm.SSMConfig(d_state=16, expand=2, headdim=16, chunk=16)
    cfg = ssm.SSMConfig(d_state=16, expand=2, headdim=16, chunk=16)
    params, _ = jssm.mamba2_init(jax.random.PRNGKey(0), 64, jcfg)
    block, _ = ssm.mamba2_init(torch.Generator(), 64, cfg)
    convert._load(block, jax.tree.map(np.asarray, params), "p", set())
    x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(
        np.float32)

    def jloss(p, jx):
        return jnp.sum(jnp.square(jssm.mamba2_forward(p, jx, d=64,
                                                      cfg=jcfg)))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ssm.mamba2_forward(block, tx, d=64, cfg=cfg).square().sum().backward()
    assert rel_l2(tx.grad.numpy(), np.asarray(jgx)) <= TOL
    for path, g in flat(jgp).items():
        p = block
        for k in path:
            p = getattr(p, k)
        assert rel_l2(p.grad.numpy(), g) <= TOL, path


# ---------------------------------------------------------------------------
# Checkpoints across the packages.
# ---------------------------------------------------------------------------

def trained(arch):
    """(JAX config, params; port config, model, params, opt state) after
    one port train step (moments not zero)."""
    jcfg, jparams, cfg, model = pair(arch)
    params = steps.param_dict(model)
    state = opt_lib.init(params)
    step = steps.make_train_step(model, cfg, opt_lib.OptConfig(warmup=0))
    step(params, state, batch_of(cfg)[1])
    return jcfg, jparams, cfg, model, params, state


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_port_checkpoint_restores_into_jax(tmp_path, arch):
    jcfg, jparams, cfg, model, params, state = trained(arch)
    tree = steps.ckpt_tree(cfg, model)(params, state)
    ckpt.save(str(tmp_path), 1, tree, extra={"next_step": 2})
    like = {"params": jparams, "opt": jopt.init(jparams)}
    jstate, manifest = jckpt.restore(str(tmp_path), 1, like)
    assert manifest["extra"] == {"next_step": 2}
    assert int(jstate["opt"]["step"]) == 1
    hold_tree(cfg, model, params, jstate["params"], 0.0, rel=False)
    hold_tree(cfg, model, state["m"], jstate["opt"]["m"], 0.0, rel=False)
    hold_tree(cfg, model, state["v"], jstate["opt"]["v"], 0.0, rel=False)


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, arch):
    jcfg, jparams, cfg, model, params, state = trained(arch)
    rng = np.random.default_rng(4)
    jg = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
        p.shape).astype(np.float32)), jparams)
    jp, js, _ = jopt.update(jopt.OptConfig(), jg, jopt.init(jparams),
                            jparams)
    jckpt.save(str(tmp_path), 7, {"params": jp, "opt": js},
               extra={"next_step": 8})
    live = steps.ckpt_tree(cfg, model)(params, state)
    restored, manifest = ckpt.restore(str(tmp_path), 7, live)
    ckpt.assign(live, restored)
    assert manifest["extra"] == {"next_step": 8}
    assert restored["opt"]["step"] == 1
    hold_tree(cfg, model, params, jp, 0.0, rel=False)
    hold_tree(cfg, model, state["m"], js["m"], 0.0, rel=False)
    hold_tree(cfg, model, state["v"], js["v"], 0.0, rel=False)
    # the restore wrote into the model's own tensors
    assert steps.param_dict(model)["lnf/g"] is params["lnf/g"]


# ---------------------------------------------------------------------------
# Crash and resume.
# ---------------------------------------------------------------------------

def run_loop(ckpt_dir, fail_at=None, log=None):
    cfg = configs.lm_reduced("zamba2-7b")
    model, _ = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = opt_lib.OptConfig(lr=1e-3, warmup=1, total_steps=5)
    return loop_lib.run(
        loop_lib.LoopConfig(total_steps=5, ckpt_dir=str(ckpt_dir),
                            ckpt_every=2, log_every=1),
        init_params=lambda: steps.param_dict(model),
        train_step=steps.make_train_step(model, cfg, opt_cfg),
        next_batch=lambda s: launch_train.make_batch(cfg, 0, s, 2, 16),
        opt_cfg=opt_cfg, ckpt_tree=steps.ckpt_tree(cfg, model),
        decay=steps.decay_names(cfg, model), fail_at=fail_at,
        log=log or (lambda *_: None))


def test_crash_and_resume_equal_an_uninterrupted_run(tmp_path):
    want_p, want_s, want_i = run_loop(tmp_path / "whole")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        run_loop(tmp_path / "crash", fail_at=3)
    assert ckpt.latest_step(str(tmp_path / "crash")) == 2
    logs = []
    got_p, got_s, got_i = run_loop(tmp_path / "crash", log=logs.append)
    assert "[loop] restored step 2, resuming at 3" in logs
    assert [h["step"] for h in got_i["history"]] == [3, 4]
    assert [h["loss"] for h in got_i["history"]] == \
        [h["loss"] for h in want_i["history"][3:]]
    assert got_s["step"] == want_s["step"] == 5
    for k, p in want_p.items():
        assert torch.equal(got_p[k], p), k
        assert torch.equal(got_s["m"][k], want_s["m"][k]), k
        assert torch.equal(got_s["v"][k], want_s["v"][k]), k


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra", [
    ("smollm-135m", ()), ("granite-moe-3b-a800m", ("--microbatch", "2")),
    ("zamba2-7b", ()), ("xlstm-1.3b", ()),
    ("smollm-135m", ("--compression", "int8"))])
def test_launch_train_on_the_cpu(arch, extra):
    info = launch_train.main(["--arch", arch, "--steps", "3", "--batch", "2",
                              "--seq", "16", "--device", "cpu", *extra],
                             log=lambda *_: None)
    losses = [h["loss"] for h in info["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_compressed_launch_train_decays_as_the_reference(monkeypatch):
    """On the error-feedback path the loop applies AdamW itself: the LM's
    trainer hands it the stacked-rank decay set, so a layer's norm gain
    is decayed there too and the final norm's is not."""
    seen = []
    update = opt_lib.update

    def spy(*a, decay=None, **kw):
        seen.append(decay)
        return update(*a, decay=decay, **kw)

    monkeypatch.setattr(opt_lib, "update", spy)
    run = launch_train.main(["--arch", "zamba2-7b", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--compression", "int8"], log=lambda *_: None)
    want = steps.decay_names(run["cfg"], run["model"])
    assert seen == [want, want]
    assert {"blocks/0/ln1/g", "blocks/0/mix/A_log"} <= want
    # the shared attention block, first placed at blocks/2, is not stacked
    assert {"lnf/g", "blocks/2/ln1/g"}.isdisjoint(want)


def test_launch_train_restarts_from_its_checkpoint(tmp_path):
    argv = ["--arch", "zamba2-7b", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    logs = []
    first = launch_train.main(argv + ["--steps", "3"], log=logs.append)
    assert len(first["history"]) == 3
    again = launch_train.main(argv + ["--steps", "3"], log=logs.append)
    assert again["history"] == []
    assert logs[-1].startswith("[train] nothing to do")
    more = launch_train.main(argv + ["--steps", "5"], log=logs.append)
    assert "[loop] restored step 3, resuming at 3" in logs
    assert [h["step"] for h in more["history"]] == [3, 4]
    assert np.isfinite([h["loss"] for h in more["history"]]).all()


def test_launch_train_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1"], log=lambda *_: None)


def test_hold_grads_takes_gradients_all_zero_on_both_sides():
    """An LM's expert that no token reached has an all-zero gradient on
    the CPU; with ``zero_ok`` it must be all zero on the card too."""
    from repro_torch.kernels import checks
    cpu = {"a": torch.ones(3), "expert": torch.zeros(2)}
    rel = checks.hold_grads({k: v.clone() for k, v in cpu.items()}, cpu,
                            zero_ok=True)
    assert rel == {"a": 0.0, "expert": 0.0}
    with pytest.raises(AssertionError, match="no gradient"):
        checks.hold_grads({k: v.clone() for k, v in cpu.items()}, cpu)
    with pytest.raises(AssertionError, match="all-zero gradient on the CPU"):
        checks.hold_grads({"a": torch.ones(3), "expert": torch.ones(2)}, cpu,
                          zero_ok=True)
    with pytest.raises(AssertionError, match="non-finite"):
        checks.hold_grads({"a": torch.tensor([1.0, float("nan"), 1.0]),
                           "expert": torch.zeros(2)}, cpu, zero_ok=True)
