"""The host mesh: ("data", "model") over the cards of one host.

Counterpart of ``repro.launch.mesh.make_host_mesh``, laid over the ranks
of the process world (one process a card, started by torchrun; a world of
one without it) instead of the local devices of one process.  The
reference's ``make_production_mesh`` (the TPU v5e pod shapes) has no
counterpart.
"""
from __future__ import annotations

from repro_torch.dist import elastic, process
from repro_torch.dist.logical import Mesh


def host_mesh_shape(n: int, model_axis: int = 2) -> tuple:
    """The reference's arithmetic: the largest model axis up to
    ``model_axis`` that divides ``n``, the rest data."""
    model_axis = min(model_axis, n)
    while n % model_axis:
        model_axis -= 1
    return (n // model_axis, model_axis)


def make_host_mesh(model_axis: int = 2, device=None) -> Mesh:
    """The ("data", "model") mesh over the world's ranks; ``device`` as
    ``process.init`` takes it (None: the card; ``"cpu"``: gloo)."""
    world = process.init(device)
    return elastic.world_mesh(world, host_mesh_shape(world.size, model_axis),
                              ("data", "model"))
