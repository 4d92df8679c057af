"""Elastic mesh selection for degraded-device serving.

Counterpart of ``repro.dist.elastic``.  ``choose_mesh_shape`` and
``degraded_meshes`` are the reference's arithmetic, unchanged: the best
(data, model) factorization of a device count, and the sequence of
meshes left as hosts are lost.  ``make_mesh`` lays the visible cards out
on that shape; on one card it is the (1, 1) ("data", "model") mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
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


def make_mesh(*, model_axis: int = 2, devices=None) -> Mesh:
    """A mesh over ``devices``; ``None`` means every visible card (and
    raises where there is none, as ``device.resolve_device`` does)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    shape, names = choose_mesh_shape(len(devices), model_axis=model_axis)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), names)

