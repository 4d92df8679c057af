"""The port's segmentation loss and gradients against the JAX package.

The segmentation half of tests/test_torch_grads.py (which holds the method
and the 1e-4 bar): its FP stages carry the gradient back through the
interpolation's gather, whose backward is ``scatter_add_blocks``.
"""
import pytest

pytest.importorskip("torch")

from test_torch_grads import hold_grads_against_jax  # noqa: E402


def test_seg_loss_and_grads_match_jax():
    hold_grads_against_jax("pointnet2_seg", 256, 64)
