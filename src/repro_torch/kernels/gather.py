"""Block-wise in-window gather and its backward: CUDA kernels and plain
versions.

Counterparts of ``repro.kernels.gather.gather_blocks`` and
``scatter_add_blocks`` (the Pallas kernels' one-hot matmul and its
transpose) and of their oracles in ``repro.kernels.ref``.  The backward
runs in training only, through ``kernels.vjp.Gathering``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import launching_on, on_card, require


def gather_plain(window_feats: torch.Tensor, idx: torch.Tensor):
    """window_feats (NB, W, C), idx (NB, M) -> (NB, M, C); an index outside
    [0, W) fetches zeros."""
    nb, w, c = window_feats.shape
    ok = (idx >= 0) & (idx < w)
    safe = idx.clamp(0, w - 1).long()
    out = torch.gather(window_feats, 1,
                       safe[..., None].expand(nb, idx.shape[1], c))
    return torch.where(ok[..., None], out, 0.0)


def gather_blocks(window_feats: torch.Tensor, idx: torch.Tensor):
    """window_feats (NB, W, C) f32, idx (NB, M) int32 -> (NB, M, C).

    On the card this launches ``csrc/gather.cu``; on the CPU it runs
    ``gather_plain``."""
    if not on_card(window_feats, idx):
        return gather_plain(window_feats, idx)
    nb, w, c = window_feats.shape
    m = idx.shape[1]
    require(window_feats, "window_feats", torch.float32, (nb, w, c))
    require(idx, "idx", torch.int32, (nb, m))
    out = torch.empty((nb, m, c), dtype=torch.float32,
                      device=window_feats.device)
    if nb == 0 or m == 0 or c == 0:
        return out
    with launching_on(window_feats) as stream:
        err = _build.library().fc_gather_blocks(
            window_feats.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, w,
            c, m, stream)
    _build.check(err, "gather_blocks")
    gather_blocks.launches += 1
    return out


gather_blocks.launches = 0


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor, *, w: int):
    """g (NB, M, C), idx (NB, M) -> (NB, W, C): each row of ``g`` added into
    the window row ``idx`` names; a row whose index lies outside [0, W) goes
    to a sink row that is sliced off.

    One masked ``scatter_add_`` into the (NB, W+1, C) buffer per row
    position ``m``, in order, so that every cell sums its rows in row
    order on either device, as the kernel does (CUDA's ``scatter_add_`` of
    all rows at once adds with atomics in no fixed order)."""
    nb, m, c = g.shape
    ok = (idx >= 0) & (idx < w)
    slot = torch.where(ok, idx.long(), w)[..., None, None].expand(nb, m, 1, c)
    out = g.new_zeros((nb, w + 1, c))
    for j in range(m):
        out.scatter_add_(1, slot[:, j], g[:, j:j + 1])
    return out[:, :w]


def scatter_add_blocks(g: torch.Tensor, idx: torch.Tensor, *, w: int):
    """g (NB, M, C) f32, idx (NB, M) int32 -> (NB, W, C): the backward of
    ``gather_blocks`` over a window of ``w`` rows.

    On the card this launches ``csrc/scatter_add.cu``; on the CPU it runs
    ``scatter_add_plain``."""
    if not on_card(g, idx):
        return scatter_add_plain(g, idx, w=w)
    nb, m, c = g.shape
    require(g, "g", torch.float32, (nb, m, c))
    require(idx, "idx", torch.int32, (nb, m))
    out = torch.empty((nb, w, c), dtype=torch.float32, device=g.device)
    if nb == 0 or w == 0 or c == 0:
        return out
    with launching_on(g) as stream:
        err = _build.library().fc_scatter_add_blocks(
            g.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, m, c, w, stream)
    _build.check(err, "scatter_add_blocks")
    scatter_add_blocks.launches += 1
    return out


scatter_add_blocks.launches = 0
