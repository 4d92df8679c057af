"""Public point ops at the caller's shapes -- the port's dispatch layer.

Counterpart of ``repro.kernels.ops``.  Kernel selection follows the device
and nothing else: a CPU tensor runs the plain PyTorch version, a CUDA
tensor launches the hand-written kernel (or the call raises).  There is no
``impl`` argument and no environment variable.

Every op takes the caller's layout -- points ``(NB, BS, 3)``, masks
``(NB, BS)`` -- and ``chunk``: with it, the block axis is processed
``chunk`` blocks per call, in a Python loop, bounding the live distance
tile at large scale.  ``leaf_chunks`` is the shared splitting helper.

Every op carries its gradient rule (``kernels/vjp.py``) on both devices:
``gather_blocks`` differentiates in its features, its backward the
``scatter_add_blocks`` kernel (chunked as the forward was, one
``Gathering`` node per chunk); FPS, ball query and kNN are index producers
that pass no gradient on, and so is ``fractal_level_blocks``, whose side
bits, counts and child extrema get zero cotangents.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ball_query as _bq
from repro_torch.kernels import fps as _fps
from repro_torch.kernels import fractal_level as _fl
from repro_torch.kernels import gather as _ga
from repro_torch.kernels import knn as _knn
from repro_torch.kernels.vjp import Gathering, IndexProducer

KERNELS = {"fps_blocks": _fps.fps_blocks,
           "ball_query_blocks": _bq.ball_query_blocks,
           "knn_blocks": _knn.knn_blocks,
           "gather_blocks": _ga.gather_blocks,
           "scatter_add_blocks": _ga.scatter_add_blocks,
           "fractal_level_blocks": _fl.fractal_level_blocks}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def pad_points(coords: torch.Tensor, n: int, valid: torch.Tensor | None = None):
    """Grow a ``(..., p, 3)`` cloud to exactly ``n`` points, the tail marked
    invalid.  Returns ``(coords (..., n, 3), valid (..., n) bool)``."""
    p = coords.shape[-2]
    if n < p:
        raise ValueError(f"cannot pad {p} points down to {n}")
    if valid is None:
        valid = torch.ones(coords.shape[:-1], dtype=torch.bool,
                           device=coords.device)
    pad = n - p
    if pad:
        coords = torch.cat([coords, coords.new_zeros(
            (*coords.shape[:-2], pad, coords.shape[-1]))], dim=-2)
        valid = torch.cat([valid.bool(), valid.new_zeros(
            (*valid.shape[:-1], pad), dtype=torch.bool)], dim=-1)
    return coords, valid.bool()


def leaf_chunks(arrays, chunk: int | None, dim: int = 0):
    """Split each array along ``dim`` into ``chunk``-sized pieces (the last
    one shorter).  Returns a list of tuples, one per chunk."""
    n = arrays[0].shape[dim]
    if chunk is None or chunk >= n:
        return [tuple(arrays)]
    return [tuple(a.narrow(dim, s, min(chunk, n - s)) for a in arrays)
            for s in range(0, n, chunk)]


def _chunked(fn, arrays, chunk):
    outs = [fn(*xs) for xs in leaf_chunks(arrays, chunk)]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, 0) for parts in zip(*outs))
    return torch.cat(outs, 0)


def _index_producer(fn, arrays, chunk):
    return IndexProducer.apply(lambda *xs: _chunked(fn, xs, chunk), *arrays)


def _pts(x):
    return x.to(torch.float32).contiguous()


def _mask(m):
    return m.to(torch.bool).contiguous()


def fps_blocks(coords, mask, *, k: int, chunk: int | None = None):
    """coords (NB, BS, 3), mask (NB, BS) -> sampled in-block idx (NB, k).

    If ``k`` exceeds a block's valid count, the exhausted slots repeat the
    last valid selection (empty blocks repeat index 0)."""
    return _index_producer(lambda c, m: _fps.fps_blocks(c, m, k=k),
                           (_pts(coords), _mask(mask)), chunk)


def ball_query_blocks(centers, cmask, window, wmask, *, radius: float,
                      num: int, chunk: int | None = None):
    """centers (NB,KC,3), cmask (NB,KC), window (NB,W,3), wmask (NB,W)
    -> (idx (NB,KC,num) local-to-window, d2 (NB,KC,num), cnt (NB,KC))."""
    return _index_producer(
        lambda c, cm, w, wm: _bq.ball_query_blocks(c, cm, w, wm,
                                                   radius=radius, num=num),
        (_pts(centers), _mask(cmask), _pts(window), _mask(wmask)), chunk)


def knn_blocks(queries, window, wmask, *, k: int, chunk: int | None = None):
    """queries (NB,Q,3), window (NB,W,3), wmask (NB,W)
    -> (idx (NB,Q,k) local-to-window, d2 (NB,Q,k))."""
    return _index_producer(lambda q, w, wm: _knn.knn_blocks(q, w, wm, k=k),
                           (_pts(queries), _pts(window), _mask(wmask)),
                           chunk)


def gather_blocks(window_feats, idx, *, chunk: int | None = None):
    """window_feats (NB, W, C), idx (NB, M) local-to-window -> (NB, M, C);
    an index outside [0, W) fetches zeros.  Differentiable in
    ``window_feats``; out-of-range rows get no gradient."""
    return _chunked(
        lambda f, i: Gathering.apply(_ga.gather_blocks,
                                     _ga.scatter_add_blocks, f, i),
        (_pts(window_feats), idx.to(torch.int32).contiguous()), chunk)


def fractal_level_blocks(coords, mask, mid, *, da: int, db: int,
                         chunk: int | None = None):
    """coords (NB,BS,3), mask (NB,BS), mid (NB,) -> (side (NB,BS) int32,
    left_count (NB,) int32, child_stats (NB,4) f32 = [lmin_b, lmax_b,
    rmin_b, rmax_b]): one partition level per block, split on ``da`` at
    ``mid`` (a lane at ``mid`` goes left), extrema of ``db`` per side."""
    return _index_producer(
        lambda c, m, md: _fl.fractal_level_blocks(c, m, md, da=da, db=db),
        (_pts(coords), _mask(mask), mid.to(torch.float32).contiguous()),
        chunk)
