"""One fractal partition level per block: CUDA kernel and plain version.

Counterpart of ``repro.kernels.fractal_engine.fractal_level_blocks`` (the
Pallas kernel, paper Fig. 9(b,c): the partition unit and the midpoint unit
pipelined in one pass) and of its oracle
``repro.kernels.ref.fractal_level_blocks``, in the caller's layout: coords
``(NB, BS, 3)``, a bool mask ``(NB, BS)`` and one split value a block.

For each block it returns which lanes go right (``x[da] > mid``, so a lane
exactly at ``mid`` goes left), how many valid lanes go left, and the
extrema of the next split dimension ``db`` on each side, from which both
children's midpoints follow without a second pass.  An empty side gives
the sentinels ``INF`` / ``NEG``.  Minimum, maximum and count are exact in
any order, so kernel and plain version agree exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import INF, NEG, on_card, require


def fractal_level_plain(coords: torch.Tensor, mask: torch.Tensor,
                        mid: torch.Tensor, *, da: int, db: int):
    """-> (side (NB,BS) int32, left_count (NB,) int32, child_stats (NB,4)
    f32 = [lmin_b, lmax_b, rmin_b, rmax_b])."""
    xa, xb = coords[..., da], coords[..., db]
    side = (xa > mid[:, None]) & mask
    left = mask & ~side
    stats = torch.stack([
        torch.where(left, xb, INF).amin(-1),
        torch.where(left, xb, NEG).amax(-1),
        torch.where(side, xb, INF).amin(-1),
        torch.where(side, xb, NEG).amax(-1)], -1)
    return (side.to(torch.int32), left.sum(-1, dtype=torch.int32),
            stats.to(torch.float32))


def fractal_level_blocks(coords: torch.Tensor, mask: torch.Tensor,
                         mid: torch.Tensor, *, da: int, db: int):
    """coords (NB,BS,3) f32, mask (NB,BS) bool, mid (NB,) f32 -> (side
    (NB,BS) int32, left_count (NB,) int32, child_stats (NB,4) f32).

    On the card this launches ``csrc/fractal_level.cu``; on the CPU it runs
    ``fractal_level_plain``."""
    if not (da in (0, 1, 2) and db in (0, 1, 2)):
        raise ValueError(f"da and db must be 0, 1 or 2, got {da}, {db}")
    if not on_card(coords, mask, mid):
        return fractal_level_plain(coords, mask, mid, da=da, db=db)
    nb, bs = mask.shape
    require(coords, "coords", torch.float32, (nb, bs, 3))
    require(mask, "mask", torch.bool, (nb, bs))
    require(mid, "mid", torch.float32, (nb,))
    dev = coords.device
    side = torch.empty((nb, bs), dtype=torch.int32, device=dev)
    lcnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    stats = torch.empty((nb, 4), dtype=torch.float32, device=dev)
    if nb == 0:
        return side, lcnt, stats
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.library().fc_fractal_level_blocks(
        coords.data_ptr(), mask.data_ptr(), mid.data_ptr(), side.data_ptr(),
        lcnt.data_ptr(), stats.data_ptr(), nb, bs, da, db, stream)
    _build.check(err, "fractal_level_blocks")
    fractal_level_blocks.launches += 1
    return side, lcnt, stats


fractal_level_blocks.launches = 0
