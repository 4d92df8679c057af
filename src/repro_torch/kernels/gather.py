"""Block-wise in-window gather (forward): CUDA kernel and plain version.

Counterpart of ``repro.kernels.gather.gather_blocks`` (the Pallas kernel's
one-hot matmul) and of its oracle ``repro.kernels.ref.gather_blocks``.
The backward, ``scatter_add_blocks``, belongs to training and is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import on_card, require


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
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.library().fc_gather_blocks(
        window_feats.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, w, c, m,
        stream)
    _build.check(err, "gather_blocks")
    gather_blocks.launches += 1
    return out


gather_blocks.launches = 0
