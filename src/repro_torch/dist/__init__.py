"""repro_torch.dist: the distribution subsystem.

* ``process``     the process world: one process a card under torchrun,
  NCCL on the card (gloo for ``device="cpu"``), a world of one without it
* ``logical``     logical-axis rules, the ``lc`` constraint helper, and
  ``shard`` / ``unshard``: a rank's slice of a dim and its all-gather
* ``elastic``     degraded-device mesh selection, ``make_mesh`` over the
  world's ranks with its process groups
* ``compression`` gradient codecs (bf16 / stochastic int8) + error
  feedback

The reference's ``compat`` (shims for jax's mesh API across versions) has
no counterpart: the port builds its own ``Mesh``.
"""
from repro_torch.dist import compression, elastic, logical, process

__all__ = ["compression", "elastic", "logical", "process"]
