"""Block-wise ball query: CUDA kernel and plain version.

Counterpart of ``repro.kernels.ball_query.ball_query_blocks`` (the Pallas
kernel) and of its oracle ``repro.kernels.ref.ball_query_blocks``, in the
caller's layout: centers ``(NB, KC, 3)``, window ``(NB, W, 3)``, bool masks.

The two JAX paths square the radius differently and each is reproduced
where it is used: the Pallas kernel squares it as a Python double and
rounds the square to f32 (the CUDA launch here does the same); the oracle
squares ``float32(radius)`` in f32 (``ball_query_plain`` does the same).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (INF, argmin_extract, f32_square,
                                        on_card, require, sqdist_rows)


def ball_query_plain(centers, cmask, window, wmask, *, radius: float,
                     num: int):
    """-> (idx (NB,KC,num) int32 local to the window, d2 (NB,KC,num) f32,
    cnt (NB,KC) int32)."""
    d = sqdist_rows(centers, window)
    d = torch.where(wmask[:, None, :], d, INF)
    in_r = (d <= f32_square(radius)) & wmask[:, None, :]
    cnt = torch.where(cmask, in_r.sum(-1), 0).to(torch.int32)
    idx, val = argmin_extract(d, num)
    return idx, val, cnt


def ball_query_blocks(centers, cmask, window, wmask, *, radius: float,
                      num: int):
    """centers (NB,KC,3), cmask (NB,KC), window (NB,W,3), wmask (NB,W)
    -> (idx (NB,KC,num) int32, d2 (NB,KC,num) f32, cnt (NB,KC) int32).

    On the card this launches ``csrc/ball_query.cu``; on the CPU it runs
    ``ball_query_plain``."""
    if not on_card(centers, cmask, window, wmask):
        return ball_query_plain(centers, cmask, window, wmask, radius=radius,
                                num=num)
    nb, kc = cmask.shape
    w = wmask.shape[1]
    require(centers, "centers", torch.float32, (nb, kc, 3))
    require(cmask, "cmask", torch.bool, (nb, kc))
    require(window, "window", torch.float32, (nb, w, 3))
    require(wmask, "wmask", torch.bool, (nb, w))
    dev = centers.device
    idx = torch.empty((nb, kc, num), dtype=torch.int32, device=dev)
    d2 = torch.empty((nb, kc, num), dtype=torch.float32, device=dev)
    cnt = torch.empty((nb, kc), dtype=torch.int32, device=dev)
    if nb == 0 or kc == 0:
        return idx, d2, cnt
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.library().fc_ball_query_blocks(
        centers.data_ptr(), cmask.data_ptr(), window.data_ptr(),
        wmask.data_ptr(), idx.data_ptr(), d2.data_ptr(), cnt.data_ptr(),
        nb, kc, w, num, float(radius) ** 2, stream)
    _build.check(err, "ball_query_blocks")
    ball_query_blocks.launches += 1
    return idx, d2, cnt


ball_query_blocks.launches = 0
