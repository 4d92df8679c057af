"""The FP stage's 3-NN inverse-distance blend over the occupied leaf lanes:
a CUDA kernel and its plain version.

No TPU kernel stands behind this one: the JAX package blends with jnp in
``repro.core.bppo.blockwise_interpolate`` (a product with the weights, a sum
over the three neighbours, a scatter of every leaf lane, padded lanes to a
sink row).  Here ``core.bppo.blockwise_interpolate`` hands the in-window
gather's output (NB, bs * 3, C), its IDW weights (NB, bs, 3) and, per leaf
block, its first row in the partition's sorted frame and its occupied-lane
count; a leaf's occupied lanes are a prefix whose rows are contiguous.
Only those lanes are blended and written, so the padded lanes (most of
them at level 0) cost no read and no write.

``interp_blend`` launches ``csrc/interp_blend.cu`` for CUDA tensors and runs
``interp_blend_plain`` for CPU ones; the two agree bit for bit on the card,
as every point kernel and its plain version do.  Both write into ``out`` in
place.  The gradient rule is ``kernels.vjp.Blending``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import launching_on, on_card, require


def occupied_rows(out_rows: int, leaf_start, count, bs: int):
    """(row (NB, bs) int64, keep (NB, bs) bool): lane j of leaf block nb
    writes row ``leaf_start[nb] + j`` of its cloud where j < count[nb] and
    that row lies in [0, out_rows)."""
    lane = torch.arange(bs, device=leaf_start.device)
    row = leaf_start[:, None].long() + lane
    keep = (lane < count[:, None]) & (row >= 0) & (row < out_rows)
    return row, keep


def interp_blend_plain(out, vals, wgt, leaf_start, count):
    """out (B, R, C), vals (NB, bs * 3, C), wgt (NB, bs, 3), leaf_start
    (NB,), count (NB,), NB = B * leaves -> out, written in place: for each
    leaf block nb (cloud nb // leaves) and lane j < count[nb] whose row
    r = leaf_start[nb] + j lies in [0, R), ``out[b, r] = (v0 * w0 + v1 * w1)
    + v2 * w2`` with v_k the row 3j + k of the block's vals and w_k its
    weight, each operation rounded on its own, k = 0, 1, 2 (the order of the
    former multiply-and-``sum(-2)``, bit for bit on the CPU).  Other rows of
    out keep their values; a padded lane is never read."""
    b, r, c = out.shape
    nb, bs = wgt.shape[:2]
    if nb == 0:
        return out
    row, keep = occupied_rows(r, leaf_start, count, bs)
    cloud = (torch.arange(nb, device=out.device) // (nb // b))[:, None]
    p = vals.reshape(nb, bs, 3, c)[keep] * wgt[keep][..., None]
    out[cloud.expand(nb, bs)[keep], row[keep]] = (p[:, 0] + p[:, 1]) + p[:, 2]
    return out


def interp_blend(out, vals, wgt, leaf_start, count):
    """out (B, R, C) f32, vals (NB, bs * 3, C) f32, wgt (NB, bs, 3) f32,
    leaf_start (NB,) int32, count (NB,) int32 -> out, written in place as
    ``interp_blend_plain`` writes it.

    On the card this launches ``csrc/interp_blend.cu``; on the CPU it runs
    ``interp_blend_plain``."""
    if not on_card(out, vals, wgt, leaf_start, count):
        return interp_blend_plain(out, vals, wgt, leaf_start, count)
    b, r, c = out.shape
    nb, bs = wgt.shape[:2]
    leaves = nb // b if b else 0
    if nb != b * leaves:
        raise ValueError(f"{nb} leaf blocks do not split evenly over {b} "
                         f"clouds")
    require(out, "out", torch.float32, (b, r, c))
    require(vals, "vals", torch.float32, (nb, bs * 3, c))
    require(wgt, "wgt", torch.float32, (nb, bs, 3))
    require(leaf_start, "leaf_start", torch.int32, (nb,))
    require(count, "count", torch.int32, (nb,))
    if nb == 0 or r == 0 or c == 0 or bs == 0:
        return out
    with launching_on(out) as stream:
        err = _build.library().fc_interp_blend(
            out.data_ptr(), vals.data_ptr(), wgt.data_ptr(),
            leaf_start.data_ptr(), count.data_ptr(), b, leaves, r, bs, c,
            stream)
    _build.check(err, "interp_blend")
    interp_blend.launches += 1
    return out


interp_blend.launches = 0
