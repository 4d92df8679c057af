"""Elastic mesh selection for degraded-device serving.

Counterpart of ``repro.dist.elastic``.  ``choose_mesh_shape`` and
``degraded_meshes`` are the reference's arithmetic, unchanged: the best
(data, model) factorization of a device count, and the sequence of
meshes left as hosts are lost.  ``make_mesh`` lays the ranks of the
process world (``dist/process.py``: one process a card, started by
torchrun) out on that shape, and builds the process groups its axes need;
a world of one is the (1, 1) ("data", "model") mesh.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import process
from repro_torch.dist.logical import Mesh

HOST_SIZE = 8     # chips per host: the failure granularity
POD_SIZE = 256    # chips per pod


def choose_mesh_shape(n_devices: int, *, model_axis: int = 16,
                      pod_size: int = POD_SIZE):
    """Device count -> (mesh shape, axis names).

    Multi-pod counts get ("pod", "data", "model") with the per-pod
    topology 16 x pod_size/16 (``model_axis`` does not apply there);
    anything else gets ("data", "model") with the largest model axis
    <= ``model_axis`` that divides ``n_devices``."""
    if n_devices <= 0:
        raise ValueError(f"need at least one device, got {n_devices}")
    if (n_devices >= 2 * pod_size and n_devices % pod_size == 0
            and pod_size >= 16 and pod_size % 16 == 0):
        return ((n_devices // pod_size, 16, pod_size // 16),
                ("pod", "data", "model"))
    m = min(model_axis, n_devices)
    while n_devices % m:
        m -= 1
    return (n_devices // m, m), ("data", "model")


def degraded_meshes(n_devices: int, n_losses: int, *,
                    host_size: int = HOST_SIZE, model_axis: int = 16):
    """[(shape, names)] for the healthy mesh and each of ``n_losses``
    successive lost hosts."""
    return [choose_mesh_shape(n_devices - i * host_size,
                              model_axis=model_axis)
            for i in range(n_losses + 1)]


def make_mesh(*, model_axis: int = 2, devices=None, device=None) -> Mesh:
    """The elastic mesh: ``choose_mesh_shape`` of the world's size, laid
    over its ranks (``world_mesh``).  ``device`` is this process's kind,
    as ``process.init`` takes it (None: the card, raising where there is
    none; ``"cpu"``: gloo).  With ``devices`` the mesh lays out those
    devices in this process instead: one for the one-card mesh, several
    for a stand-in that specs read but that holds no shard."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        shape, names = choose_mesh_shape(len(devices), model_axis=model_axis)
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        return Mesh(grid.reshape(shape), names)
    world = process.init(device)
    shape, names = choose_mesh_shape(world.size, model_axis=model_axis)
    return world_mesh(world, shape, names)


def world_mesh(world: process.World, shape, names) -> Mesh:
    """The ranks of ``world`` laid out row-major on ``shape``, and one
    process group for each combination of axes that holds more than one
    rank.  Every rank makes the same ``new_group`` calls in the same
    order, as torch.distributed requires."""
    if int(np.prod(shape)) != world.size:
        raise ValueError(f"a mesh of shape {tuple(shape)} over a world of "
                         f"{world.size}")
    ranks = np.arange(world.size).reshape(shape)
    if world.backend is None:
        devices = [world.device]
    else:
        devices = [None] * world.size
        dist.all_gather_object(devices, str(world.device))
        devices = [torch.device(d) for d in devices]
    grid = np.empty(world.size, dtype=object)
    grid[:] = devices
    groups = {}
    for k in range(1, len(shape) + 1):
        for axes in itertools.combinations(range(len(shape)), k):
            ways = int(np.prod([shape[a] for a in axes]))
            if ways == 1:
                continue
            key = tuple(names[a] for a in axes)
            rows = np.moveaxis(ranks, axes, range(-k, 0)).reshape(-1, ways)
            for members in rows:
                group = (dist.group.WORLD if ways == world.size
                         else dist.new_group(members.tolist()))
                if world.rank in members:
                    groups[key] = (group, dist.get_rank(group))
    return Mesh(grid.reshape(shape), names, ranks=ranks, world=world,
                groups=groups)
