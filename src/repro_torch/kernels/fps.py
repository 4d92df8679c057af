"""Block-parallel farthest-point sampling: CUDA kernel and plain version.

Counterpart of ``repro.kernels.fps.fps_blocks`` (the Pallas kernel) and of
its oracle ``repro.kernels.ref.fps_blocks``.  Layout is the caller's:
coords ``(NB, BS, 3)`` and a bool mask ``(NB, BS)``; the TPU's lane-major
``(NB, 3, BS)`` layout and its 128-lane padding are not carried over.
Blocks wider than ``REGISTER_LANES`` keep min-d^2 in a scratch row that
the wrapper allocates.  ``variant`` picks the kernel for a width: one
warp a block up to ``WARP_LANES``, one CTA a block with min-d^2 in
registers up to ``REGISTER_LANES``, then one CTA a block with a scratch
row; each has its own C entry (``ENTRIES``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (NEG, argmax_first, launching_on,
                                        on_card, require, sqnorm)

WARP_LANES = 512        # widest block one warp takes (16 points a lane)
REGISTER_LANES = 8192   # widest block whose min-d^2 stays in registers
ENTRIES = {"warp": "fc_fps_warp_blocks", "cta": "fc_fps_cta_blocks",
           "wide": "fc_fps_wide_blocks"}


def variant(bs: int) -> str:
    """The kernel that takes blocks of ``bs`` lanes: ``"warp"``, ``"cta"``
    or ``"wide"`` (see ``csrc/fps.cu``)."""
    if bs <= WARP_LANES:
        return "warp"
    return "cta" if bs <= REGISTER_LANES else "wide"


def fps_plain(coords: torch.Tensor, mask: torch.Tensor, k: int):
    """coords (NB, BS, 3) f32, mask (NB, BS) bool -> idx (NB, k) int32.

    Starts at the first valid lane (0 for an empty block); once every valid
    lane is picked the remaining slots repeat the last pick."""
    nb, bs, _ = coords.shape
    if k == 0:
        return torch.zeros((nb, 0), dtype=torch.int32, device=coords.device)
    lane = torch.arange(bs, device=coords.device)

    def d2_to(i):
        p = torch.gather(coords, 1, i[:, None, None].expand(nb, 1, 3))
        return sqnorm(coords - p)

    start = argmax_first(mask.to(torch.float32))
    mind = torch.where(mask, d2_to(start), NEG)
    mind = torch.where(lane == start[:, None], NEG, mind)
    picks, prev = [start], start
    for _ in range(k - 1):
        nxt = torch.where(mind.amax(-1) > NEG, argmax_first(mind), prev)
        mind = torch.minimum(mind, torch.where(mask, d2_to(nxt), NEG))
        mind = torch.where(lane == nxt[:, None], NEG, mind)
        picks.append(nxt)
        prev = nxt
    return torch.stack(picks, 1).to(torch.int32)


def fps_blocks(coords: torch.Tensor, mask: torch.Tensor, *, k: int):
    """coords (NB, BS, 3) f32, mask (NB, BS) bool -> idx (NB, k) int32.

    On the card this launches ``csrc/fps.cu``; on the CPU it runs
    ``fps_plain``."""
    if not on_card(coords, mask):
        return fps_plain(coords, mask, k)
    nb, bs = mask.shape
    require(coords, "coords", torch.float32, (nb, bs, 3))
    require(mask, "mask", torch.bool, (nb, bs))
    idx = torch.empty((nb, k), dtype=torch.int32, device=coords.device)
    if nb == 0 or k == 0:
        return idx
    _build.check(launch(_build.library(), coords, mask, idx), "fps_blocks")
    fps_blocks.launches += 1
    return idx


def launch(lib, coords: torch.Tensor, mask: torch.Tensor,
           idx: torch.Tensor, kind: str | None = None) -> int:
    """Launch ``kind`` (by default ``variant`` of this width) from the
    library ``lib`` into ``idx`` (NB, k) on the current stream of the
    coordinates' card; returns the CUDA error code."""
    nb, bs = mask.shape
    v = kind or variant(bs)
    ptrs = [coords.data_ptr(), mask.data_ptr(), idx.data_ptr()]
    if v == "wide":
        scratch = torch.empty((nb, bs), dtype=torch.float32,
                              device=coords.device)
        ptrs.append(scratch.data_ptr())
    with launching_on(coords) as stream:
        return getattr(lib, ENTRIES[v])(*ptrs, nb, bs, idx.shape[1], stream)


fps_blocks.launches = 0
