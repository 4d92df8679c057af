"""Data-parallel training on a mesh of CPU ranks, against one process.

Six steps of ``pointnet2_cls`` (n=128, th=32, batch 8, the reference's
``test_multidevice_finetune_lowers_loss`` config) on four gloo ranks, a
(2, 2) mesh: each rank trains on its two clouds with the leaf blocks over
"model"; one all-reduce over "data" gives every rank the global-mean
gradient, before error feedback on the compressed path.  The losses must
equal the one-process run's within 1e-5 and fall as the reference's do,
plain and with int8 compression, and the parameters must be bit for bit
the same on every rank.  A batch of 6 does not divide data=4 on a (4, 1)
mesh: it stays whole, and its gradient must not be summed again.  A
checkpoint written at world 4 resumes at world 2 with the losses of the
run that was not stopped.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import fit_ranks, run_ranks  # noqa: E402

CFG = dict(preset="pointnet2_cls", n_points=128, th=32, batch=8, steps=6,
           lr=3e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_process(cfg):
    from repro_torch.train import pnn as train
    model, _, info = train.fit(train.TrainConfig(device="cpu", **cfg),
                               log=lambda *_: None)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return [h["loss"] for h in info["history"]], flat.numpy()


def check(ranks, want_losses, want_params):
    first = ranks[0]["params"]
    for row in ranks:
        np.testing.assert_allclose(row["losses"], want_losses, rtol=0,
                                   atol=1e-5)
        assert row["params"].tobytes() == first.tobytes()
    np.testing.assert_allclose(first, want_params, rtol=0, atol=1e-5)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_four_ranks_train_as_one_process(compression):
    cfg = dict(CFG, grad_compression=compression)
    losses, params = one_process(cfg)
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    check(run_ranks(fit_ranks, 4, cfg, 2), losses, params)


def test_a_batch_that_does_not_divide_data_stays_whole():
    cfg = dict(CFG, batch=6, steps=3)
    losses, params = one_process(cfg)
    check(run_ranks(fit_ranks, 4, cfg, 1), losses, params)


def test_checkpoint_from_world_four_resumes_at_world_two(tmp_path):
    cfg = dict(CFG, ckpt_dir=str(tmp_path), ckpt_every=1)
    losses, params = one_process(dict(CFG))
    run_ranks(fit_ranks, 4, cfg, 2, 3)       # saves steps 1, 2; stops at 3
    resumed = run_ranks(fit_ranks, 2, cfg, 2)
    for row in resumed:
        np.testing.assert_allclose(row["losses"], losses[3:], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(row["params"], params, rtol=0, atol=1e-5)
