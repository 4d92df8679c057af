"""Block-wise k nearest neighbours: CUDA kernel and plain version.

Counterpart of ``repro.kernels.knn.knn_blocks`` (the Pallas kernel) and of
its oracle ``repro.kernels.ref.knn_blocks``, in the caller's layout:
queries ``(NB, Q, 3)``, window ``(NB, W, 3)``, bool window mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (INF, argmin_extract, on_card,
                                        require, sqdist_rows)


def knn_plain(queries, window, wmask, *, k: int):
    """-> (idx (NB,Q,k) int32 local to the window, d2 (NB,Q,k) f32)."""
    d = sqdist_rows(queries, window)
    d = torch.where(wmask[:, None, :], d, INF)
    return argmin_extract(d, k)


def knn_blocks(queries, window, wmask, *, k: int):
    """queries (NB,Q,3), window (NB,W,3), wmask (NB,W)
    -> (idx (NB,Q,k) int32, d2 (NB,Q,k) f32).

    On the card this launches ``csrc/knn.cu``; on the CPU it runs
    ``knn_plain``."""
    if not on_card(queries, window, wmask):
        return knn_plain(queries, window, wmask, k=k)
    nb, q = queries.shape[:2]
    w = wmask.shape[1]
    require(queries, "queries", torch.float32, (nb, q, 3))
    require(window, "window", torch.float32, (nb, w, 3))
    require(wmask, "wmask", torch.bool, (nb, w))
    dev = queries.device
    idx = torch.empty((nb, q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((nb, q, k), dtype=torch.float32, device=dev)
    if nb == 0 or q == 0:
        return idx, d2
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.library().fc_knn_blocks(
        queries.data_ptr(), window.data_ptr(), wmask.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), nb, q, w, k, stream)
    _build.check(err, "knn_blocks")
    knn_blocks.launches += 1
    return idx, d2


knn_blocks.launches = 0
