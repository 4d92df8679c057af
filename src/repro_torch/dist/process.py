"""The process world a mesh is laid over: one process a card.

What ``jax.distributed`` and the XLA runtime give the reference.
``torchrun`` (``python -m torch.distributed.run --nproc-per-node N``)
starts one process a card and sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; ``init`` reads them, makes the process's card current and
joins the process group: NCCL on the card, gloo only where the caller
passes ``device="cpu"`` (the CPU tests).  Without that environment the
process is a world of one and joins no group, as one JAX process on one
device has a (1, 1) mesh.

There is no fallback: a failed NCCL init raises, the card is never traded
for the CPU, and a process group already joined with another backend or
size is refused.  ``barrier``, ``broadcast_object``, ``broadcast_`` and
``shutdown`` are the few world-wide steps the entry points take, and
``log_of`` lets rank 0 alone print.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world: its rank of ``size``, its rank
    on its host, its device and the process group's backend (None for a
    world of one, which joins no group)."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str | None


def init(device=None) -> World:
    """Join the world torchrun started, or be a world of one.

    ``device`` follows ``device.resolve_device``: None is the card (this
    process's ``LOCAL_RANK``), raising where there is none; ``"cpu"`` joins
    over gloo.  On the card, local rank 0 builds the kernels while the
    other ranks of the host wait, so one ``nvcc`` run fills
    ``build/torch_ext/``.  Calling it again returns the same world."""
    device = resolve_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    if "WORLD_SIZE" not in os.environ:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return World(0, 1, 0, device, None)
    rank = int(os.environ["RANK"])
    size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    backend = BACKENDS[device.type]
    if device.type == "cuda":
        if device.index is not None and device.index != local:
            raise ValueError(f"rank {rank} (local rank {local}) was asked "
                             f"for {device}: a process drives cuda:{local}")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    world = World(rank, size, local, device, backend)
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
        if have != (backend, size, rank):
            raise RuntimeError(f"the process group is {have} (backend, "
                               f"size, rank); this world needs "
                               f"{(backend, size, rank)}")
        return world
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=size,
        device_id=device if backend == "nccl" else None)
    if backend == "nccl":
        if local == 0:
            _build.build()
        barrier(world)
    return world


def barrier(world: World) -> None:
    """Wait for every rank of the world (nothing for a world of one)."""
    if world.backend is None:
        return
    if world.backend == "nccl":
        dist.barrier(device_ids=[world.device.index])
    else:
        dist.barrier()


def broadcast_object(world: World, obj):
    """Rank 0's ``obj`` on every rank (pickled; small objects only)."""
    if world.backend is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@torch.no_grad()
def broadcast_(world: World, tensors) -> None:
    """Overwrite ``tensors`` (one device, one dtype) with rank 0's, as one
    flat bucket."""
    tensors = list(tensors)
    if world.backend is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def quiet(*_args, **_kw) -> None:
    """A log that prints nothing."""


def log_of(world: World | None, log=print):
    """``log`` on rank 0 (or without a world), ``quiet`` on the others:
    rank 0 reports for the world."""
    return log if world is None or world.rank == 0 else quiet


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
