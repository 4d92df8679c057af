"""The port's segmentation forward against the JAX package, same weights.

The segmentation half of tests/test_torch_pnn.py (which holds the method
and the 1e-4 bar): it adds the FP stages, whose interpolation runs the kNN
and gather kernels' plain versions.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_pnn import VARIANTS, hold_apply_against_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", VARIANTS)
def test_seg_apply_matches_jax(variant):
    hold_apply_against_jax(variant, "seg")
