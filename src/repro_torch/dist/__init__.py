"""repro_torch.dist: the distribution subsystem, on one card.

* ``logical``     logical-axis rules + the ``lc`` constraint helper (the
  identity on the one-card mesh)
* ``elastic``     degraded-device mesh selection, ``make_mesh`` over the
  visible cards
* ``compression`` gradient codecs (bf16 / stochastic int8) + error
  feedback

The reference's ``compat`` (shims for jax's mesh API across versions) has
no counterpart: the port builds its own ``Mesh``.
"""
from repro_torch.dist import compression, elastic, logical

__all__ = ["compression", "elastic", "logical"]
