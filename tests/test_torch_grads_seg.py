"""The port's segmentation loss and gradients against the JAX package.

The segmentation half of tests/test_torch_grads.py (which holds the method
and the 1e-4 bar): its FP stages carry the gradient back through the
interpolation's gather, whose backward is ``scatter_add_blocks``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_grads import hold_grads_against_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_seg_loss_and_grads_match_jax():
    hold_grads_against_jax("pointnet2_seg", 256, 64)
