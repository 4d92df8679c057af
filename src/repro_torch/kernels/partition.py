"""The fractal partition of B clouds as a CUDA level pass.

No TPU kernel stands behind this one: the JAX package partitions with jnp
tensor ops, and the port's plain version is that pass written in PyTorch
(``core.fractal.tensor_pass``, ~250 tensor ops a level), which
``core.fractal.partition`` runs off the card.  On the card
``csrc/partition.cu`` runs the same partition in 2 * depth + 3 launches
(init, a count and a scatter pass a level, the slot scan and the final
compaction) with int32 indices, and returns every ``FractalPartition``
field equal to the plain version's, bit for bit: minimum, maximum, counts
and the midpoint ``(lo + hi) * 0.5`` in float32 are exact in any order.

This module only launches: it returns the fields as raw tensors, by
name, and ``core.fractal.partition`` builds the partition from them (and
gathers ``coords`` again when they carry a gradient).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import launching_on, on_card, require

# The fields the launcher writes, each kind in the order it takes their
# pointers, with their shapes in (B, n, ML, L = 2**depth).
INT32_FIELDS = (("perm", "n"), ("leaf_start", "ml"), ("leaf_rsize", "ml"),
                ("leaf_vsize", "ml"), ("leaf_depth", "ml"),
                ("parent_start", "ml"), ("parent_rsize", "ml"),
                ("parent_vsize", "ml"), ("slot_of_leaf", "ml"),
                ("leaf_of_slot", "l"), ("slot_cum_leaves", "l1"),
                ("num_leaves", ""), ("traversals", ""), ("sort_passes", ""),
                ("max_leaf_vsize", ""))
BOOL_FIELDS = (("valid", "n"), ("is_leaf", "ml"), ("overflowed", ""),
               ("leaf_capacity_exceeded", ""))


def _fields(shapes, dtype, device) -> list:
    """Tensors of ``shapes``, views into one allocation."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]


def partition(coords: torch.Tensor, valid: torch.Tensor, *, th: int,
              depth: int, ml: int, dim0: int | torch.Tensor) -> dict:
    """coords (B, n, 3) f32, valid (B, n) bool, dim0 an int or an int64
    (B,) tensor, all on the card -> {field: tensor} of every
    ``FractalPartition`` field of strategy "fractal" with ``ml`` leaf slots
    and a depth cap of ``depth``; ``coords`` carry no gradient.  Tensors
    off the card raise: their partition is ``core.fractal.tensor_pass``."""
    dims = (dim0,) if isinstance(dim0, torch.Tensor) else ()
    if not on_card(coords, valid, *dims):
        raise ValueError("kernels.partition launches on the card only; "
                         "core.fractal.partition runs the tensor pass "
                         "elsewhere")
    b, n = valid.shape
    pts = coords.detach().contiguous()
    vld = valid.contiguous()
    require(pts, "coords", torch.float32, (b, n, 3))
    require(vld, "valid", torch.bool, (b, n))
    if dims:
        dim0 = dim0.contiguous()
        require(dim0, "dim0", torch.int64, (b,))
    dev = pts.device
    sizes = {"n": (b, n), "ml": (b, ml), "l": (b, 1 << depth),
             "l1": (b, (1 << depth) + 1), "": (b,)}
    lib = _build.library()
    words = ctypes.c_longlong()
    _build.check(lib.fc_partition_scratch(b, n, depth, ctypes.byref(words)),
                 "partition")
    scratch = torch.empty(words.value, dtype=torch.int32, device=dev)
    out_coords = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    i32_out = _fields([sizes[s] for _, s in INT32_FIELDS], torch.int32, dev)
    u8_out = _fields([sizes[s] for _, s in BOOL_FIELDS], torch.bool, dev)
    i32_ptrs = (ctypes.c_void_p * len(i32_out))(
        *[t.data_ptr() for t in i32_out])
    u8_ptrs = (ctypes.c_void_p * len(u8_out))(*[t.data_ptr() for t in u8_out])
    launched = ctypes.c_int()
    with launching_on(pts) as stream:
        err = lib.fc_partition(
            pts.data_ptr(), vld.data_ptr(), dim0.data_ptr() if dims else None,
            0 if dims else dim0 % 3, b, n, depth, th, ml, scratch.data_ptr(),
            out_coords.data_ptr(), i32_ptrs, u8_ptrs, ctypes.byref(launched),
            stream)
    _build.check(err, "partition")
    partition.launches += launched.value
    return {"coords": out_coords,
            **{name: t for (name, _), t in zip(INT32_FIELDS, i32_out)},
            **{name: t for (name, _), t in zip(BOOL_FIELDS, u8_out)}}


partition.launches = 0
