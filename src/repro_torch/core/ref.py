"""Global point operations: the paper's O(n^2) baseline (``point_ops="global"``).

Counterpart of ``repro.core.ref`` with the batch axis written out: every op
takes ``(B, n, ...)`` clouds and treats each cloud on its own.  The JAX
package computes these in plain jnp (no Pallas kernel), so plain tensor ops
are their faithful port, on the CPU and on the card alike.

Conventions, each kept as the JAX package has it:

* distances are the difference form ``sum((a - b)**2)``, x then y then z
  (not the expanded form of the block-parallel kernels);
* the ``k`` smallest of a row come in ascending order, the lowest index
  first on ties, as ``jax.lax.top_k`` orders them.  ``torch.topk`` promises
  no order on ties, so the selection runs on int64 keys ``(bits of d) << 32
  | index``: a distance is never negative, so its float bits order as the
  float does, and no two keys tie;
* FPS starts at the first valid point; picked and invalid points are
  pinned to ``-3e38``; ``sel_valid = arange(k) < nvalid``;
* ball query squares the radius in float32, returns the ``num`` nearest in
  ascending order, pads out-of-radius slots with the nearest index, and
  counts every valid in-radius point (0 for an invalid center).
"""
from __future__ import annotations

import torch

from repro_torch.core.fractal import take
from repro_torch.kernels.common import INF, NEG, argmax_first, f32_square

CHUNK = 256   # rows of the (rows, n) distance tile the searches hold at once


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, m, 3), (B, n, 3) -> (B, m, n) squared euclidean distances."""
    d = a[:, :, None, :] - b[:, None, :, :]
    d = d * d
    return d[..., 0] + d[..., 1] + d[..., 2]


def smallest(d: torch.Tensor, k: int):
    """The ``k`` smallest of each row of ``d`` (..., n), which holds no
    negative value: (idx (..., k) int32, values (..., k)), ascending, the
    lowest index first on ties (``jax.lax.top_k`` of ``-d``)."""
    n = d.shape[-1]
    bits = d.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | torch.arange(n, device=d.device)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = (top & 0xFFFFFFFF).to(torch.int32)
    return idx, (top >> 32).to(torch.int32).view(torch.float32)


def fps(coords: torch.Tensor, valid: torch.Tensor, k: int):
    """Farthest point sampling over B clouds: coords (B, n, 3), valid
    (B, n) -> (idx (B, k) int32, sel_valid (B, k) bool).

    ``k - 1`` dependent passes over n points, the paper's O(n*k) global
    search.  Once every valid point is picked the rest repeat index 0."""
    b, n, _ = coords.shape
    coords = coords.to(torch.float32)
    lane = torch.arange(n, device=coords.device)

    def dist_to(i):
        p = torch.gather(coords, 1, i[:, None, None].expand(b, 1, 3))
        d = coords - p
        d = d * d
        return d[..., 0] + d[..., 1] + d[..., 2]

    start = argmax_first(valid.to(torch.int32))
    mind = torch.where(valid, dist_to(start), NEG)
    mind = torch.where(lane == start[:, None], NEG, mind)
    picks = [start]
    for _ in range(k - 1):
        nxt = argmax_first(mind)
        mind = torch.minimum(mind, torch.where(valid, dist_to(nxt), NEG))
        mind = torch.where(lane == nxt[:, None], NEG, mind)
        picks.append(nxt)
    idx = torch.stack(picks, 1).to(torch.int32)
    nvalid = valid.sum(1, keepdim=True)
    sel_valid = torch.arange(k, device=coords.device)[None, :] < nvalid
    return idx, sel_valid


def ball_query(src: torch.Tensor, src_valid: torch.Tensor,
               centers: torch.Tensor, centers_valid: torch.Tensor,
               radius: float, num: int, chunk: int = CHUNK):
    """Up to ``num`` nearest in-radius neighbours: src (B, n, 3), centers
    (B, m, 3) -> (idx (B, m, num) int32, cnt (B, m) int32)."""
    r2 = f32_square(radius)
    src = src.to(torch.float32)
    idxs, cnts = [], []
    for s in range(0, centers.shape[1], chunk):
        c = centers[:, s:s + chunk].to(torch.float32)
        d = pairwise_sqdist(c, src)
        d = torch.where(src_valid[:, None, :], d, INF)
        idx, d_k = smallest(d, num)
        idx = torch.where(d_k <= r2, idx, idx[..., :1])     # pad with nearest
        cnt = (d <= r2).sum(-1, dtype=torch.int32)
        cnts.append(torch.where(centers_valid[:, s:s + chunk], cnt, 0))
        idxs.append(idx)
    return torch.cat(idxs, 1), torch.cat(cnts, 1)


def knn(src: torch.Tensor, src_valid: torch.Tensor, queries: torch.Tensor,
        k: int, chunk: int = CHUNK):
    """k nearest valid neighbours: src (B, n, 3), queries (B, m, 3) ->
    (idx (B, m, k) int32, sqdist (B, m, k))."""
    src = src.to(torch.float32)
    idxs, d2s = [], []
    for s in range(0, queries.shape[1], chunk):
        d = pairwise_sqdist(queries[:, s:s + chunk].to(torch.float32), src)
        d = torch.where(src_valid[:, None, :], d, INF)
        idx, d2 = smallest(d, k)
        idxs.append(idx)
        d2s.append(d2)
    return torch.cat(idxs, 1), torch.cat(d2s, 1)


def gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Feature gathering: feats (B, n, C), idx (B, ...) -> (B, ..., C)."""
    return take(feats, idx)


def interpolate_3nn(queries: torch.Tensor, src: torch.Tensor,
                    src_valid: torch.Tensor, feats: torch.Tensor,
                    eps: float = 1e-8):
    """Inverse-distance-weighted 3-NN feature propagation (paper Fig. 2c):
    queries (B, m, 3), src (B, n, 3), feats (B, n, C) -> (out (B, m, C),
    idx (B, m, 3), w (B, m, 3))."""
    idx, d2 = knn(src, src_valid, queries, k=3)
    w = 1.0 / (d2 + eps)
    w = w / (w[..., 0:1] + w[..., 1:2] + w[..., 2:3])
    f = gather(feats, idx) * w[..., None]
    return f[..., 0, :] + f[..., 1, :] + f[..., 2, :], idx, w
