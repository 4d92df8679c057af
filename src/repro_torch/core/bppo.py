"""Block-Parallel Point Operations (BPPO) -- paper section IV-B.

Counterpart of ``repro.core.bppo`` with the batch axis written out: every
op takes a batched ``FractalPartition`` (fields ``(B, ...)``) and returns
fields with a leading ``B``.  Each op is a *plan* (window, quota and
compaction index math, plain tensor ops here) around an *execute* step
that goes through ``kernels.ops``: the kernels see the ``B * ML`` leaf
blocks of all clouds at once, so each launches once per stage.

Under a mesh (``dist.logical``) the leaf blocks go to ranks over
``"blocks"`` (the paper's block parallelism, at the reference's ``lc``
points): each kernel call takes this rank's share of the blocks
(``logical.shard``) and its outputs are all-gathered (``unshard``), so
every rank continues with the whole; each leaf's result depends on that
leaf only, so the split leaves the outputs as they were.

All ops work in the partition's sorted (DFT) frame: their indices index
``part.coords`` and their per-point rows follow it.  A caller that keeps
the clouds' own order composes an index with ``part.perm``
(``take(part.perm, idx)``) and moves sorted rows back with
``fractal.unpermute``.  JAX's dropped out-of-range scatter writes go to
one sink slot past the end, which is then sliced off; where JAX relied on
clamping an out-of-range gather, the index is clamped explicitly.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fractal import (FractalPartition, leaf_from, leaf_view,
                                      subtree_slot_range, take, window_from)
from repro_torch.dist.logical import shard, unshard
from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import INF, f32_square


@dataclasses.dataclass(frozen=True)
class BWSamples:
    """Result of block-wise FPS (per-leaf and compacted views), batched."""

    local_idx: torch.Tensor   # (B, ML, kbm) int32 in-block index of a sample
    block_mask: torch.Tensor  # (B, ML, kbm) bool sample slot j < quota
    gidx: torch.Tensor        # (B, ML, kbm) int32 into the sorted arrays
    quota: torch.Tensor       # (B, ML) int32 round(rate * leaf_vsize)
    cum_quota: torch.Tensor   # (B, ML+1) int32 exclusive prefix of quota
    idx: torch.Tensor         # (B, k_out) int32 into the sorted arrays
    valid: torch.Tensor       # (B, k_out) bool
    coords: torch.Tensor      # (B, k_out, 3)
    leaf: torch.Tensor        # (B, k_out) int32 leaf of each sample
    total: torch.Tensor       # (B,) int32 sum of quotas (may exceed k_out)

    @property
    def k_out(self) -> int:
        return self.idx.shape[-1]


@dataclasses.dataclass(frozen=True)
class BWNeighbors:
    """Block-wise neighbour-search result, aligned with BWSamples."""

    idx: torch.Tensor    # (B, k_out, num) int32 into the sorted arrays
    mask: torch.Tensor   # (B, k_out, num) bool in-radius / valid
    cnt: torch.Tensor    # (B, k_out) int32 true neighbour count
    d2: torch.Tensor     # (B, k_out, num) squared distances


def _flat(x, lead=2):
    """Merge the leading (B, leaves) axes into one block axis."""
    return x.reshape(-1, *x.shape[lead:])


def _on_blocks(kernel, *blocks):
    """``kernel`` on this rank's share of the leaf blocks (the leading axis
    of every argument, "blocks" over the mesh), its outputs all-gathered
    back to every block."""
    nb = blocks[0].shape[0]
    out = kernel(*(shard(x, 0, "blocks") for x in blocks))
    if isinstance(out, tuple):
        return tuple(unshard(o, 0, "blocks", nb) for o in out)
    return unshard(out, 0, "blocks", nb)


def _scatter_rows(size, fill, pos, src):
    """out (B, size, ...) = fill; out[b, pos[b, i]] = src[b, i] for pos <
    size; positions >= size are dropped (through a sink row)."""
    b = pos.shape[0]
    out = torch.full((b, size + 1, *src.shape[2:]), fill, dtype=src.dtype,
                     device=src.device)
    p = pos.long().clamp(max=size)
    p = p.reshape(b, -1, *([1] * (src.dim() - 2))).expand_as(src)
    return out.scatter_(1, p, src)[:, :size]


def blockwise_fps(part: FractalPartition, *, rate: float, k_out: int,
                  bs: int, kbm: int | None = None) -> BWSamples:
    """Block-wise sampling (paper BWS): fixed-rate FPS per leaf, compacted
    leaf-major into ``k_out`` slots."""
    if kbm is None:
        kbm = max(1, int(round(rate * bs)) + 1)
    kbm = min(kbm, bs)
    b, ml, n = part.batch, part.ml, part.n
    dev = part.coords.device
    pts, mask, _ = leaf_view(part, part.coords, bs)          # (B, ML, bs, 3)
    # f32(rate) * f32(vsize), as JAX's weak-typed product; a Python scalar
    # keeps a host-to-device copy (a sync) out of the forward.
    quota = torch.round(part.leaf_vsize.to(torch.float32) * rate)
    quota = torch.where(part.is_leaf, quota.clamp(max=kbm), 0).long()

    local = _on_blocks(lambda p, m: kops.fps_blocks(p, m, k=kbm), _flat(pts),
                       _flat(mask)).reshape(b, ml, kbm)
    j = torch.arange(kbm, device=dev)
    bmask = j < quota[..., None]
    gidx = (part.leaf_start[..., None].long() + local).clamp(0, n - 1)

    cum = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(quota, 1)], 1)
    pos = torch.where(bmask, cum[:, :-1, None] + j, k_out).reshape(b, -1)
    total = cum[:, -1]
    leaf_ids = torch.arange(ml, device=dev)[:, None].expand(b, ml, kbm)
    idx_c = _scatter_rows(k_out, 0, pos, gidx.reshape(b, -1))
    leaf_c = _scatter_rows(k_out, 0, pos, leaf_ids.reshape(b, -1))
    valid_c = (torch.arange(k_out, device=dev)[None, :]
               < total.clamp(max=k_out)[:, None])
    coords_c = take(part.coords, idx_c) * valid_c[..., None]
    i32 = lambda t: t.to(torch.int32)
    return BWSamples(local_idx=local, block_mask=bmask, gidx=i32(gidx),
                     quota=i32(quota), cum_quota=i32(cum), idx=i32(idx_c),
                     valid=valid_c, coords=coords_c, leaf=i32(leaf_c),
                     total=i32(total))


def _window_to_global(widx, lidx):
    """widx (B, c, w) window slot -> sorted index; lidx (B, c, k, num)
    local-to-window -> (B, c, k, num) sorted indices."""
    wide = widx[:, :, None, :].expand(*lidx.shape[:3], widx.shape[-1])
    return torch.gather(wide, -1, lidx.long())


def _neighbor_slices(part: FractalPartition, samp: BWSamples):
    """Per-leaf slice arrays (B, ML, ...) the neighbour plans chunk over."""
    return (part.leaf_start, part.leaf_vsize, part.parent_start,
            part.parent_vsize, part.is_leaf, samp.gidx, samp.block_mask)


def _chunked_slices(sl, slice_fn, chunk):
    """Run a per-leaf-slice plan + execute body whole, or ``chunk`` leaves
    at a time (windows are built inside each chunk, so the live footprint
    is one chunk's window and distance tiles)."""
    outs = [slice_fn(s) for s in kops.leaf_chunks(sl, chunk, dim=1)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, 1) for parts in zip(*outs))


def _bq_slice(part, sl, *, r2, radius, num, w):
    ls, lv, ps, pv, il, gidx, bmask = sl
    b, c, kbm = gidx.shape
    win, wmask, widx = window_from(ls, lv, ps, pv, il, part.coords,
                                   part.valid, w)
    centers = take(part.coords, gidx)
    lidx, nd2, cnt = _on_blocks(
        lambda *a: kops.ball_query_blocks(*a, radius=radius, num=num),
        _flat(centers), _flat(bmask), _flat(win), _flat(wmask))
    lidx = lidx.reshape(b, c, kbm, num)
    nd2 = nd2.reshape(b, c, kbm, num).clamp(min=0.0)  # expanded form can
    cnt = cnt.reshape(b, c, kbm)                      # cancel below 0
    in_r = (nd2 <= r2) & bmask[..., None]
    # Pad empty slots with the nearest neighbour (ref.py convention).
    lidx = torch.where(in_r, lidx, lidx[..., :1])
    return _window_to_global(widx, lidx), in_r, cnt, nd2


def blockwise_ball_query(part: FractalPartition, samp: BWSamples, *,
                         radius: float, num: int, w: int,
                         chunk: int | None = None) -> BWNeighbors:
    """Block-wise grouping (paper BWG): centres search their parent window.
    ``chunk`` processes that many leaves of every cloud per step."""
    r2 = f32_square(radius)
    g, in_r, cnt, nd2 = _chunked_slices(
        _neighbor_slices(part, samp),
        lambda s: _bq_slice(part, s, r2=r2, radius=radius, num=num, w=w),
        chunk)
    return _compact_neighbors(samp, g, in_r, cnt, nd2, num)


def _points_slice(part, sl, *, search, w, bs):
    """One leaf slice of a stride-1 search: every lane of each leaf block
    (``bs`` lanes) a query against its leaf's parent window (``w`` lanes).
    ``search(q, qmask, win, wmask)`` over the flat blocks returns (lidx
    local to the window, ok) of shape (NB, bs, num).  Returns (each lane's
    row in the sorted frame, ``part.n`` for a lane that holds no point;
    its ``num`` indices into the sorted arrays, a slot that is not ok
    repeating slot 0; ok, false on a lane that holds no point)."""
    ls, lv, ps, pv, il = sl
    b, c = ls.shape
    pts, pmask, pidx = leaf_from(ls, lv, il, part.coords, bs)
    win, wmask, widx = window_from(ls, lv, ps, pv, il, part.coords,
                                   part.valid, w)
    lidx, ok = search(_flat(pts), _flat(pmask), _flat(win), _flat(wmask))
    num = lidx.shape[-1]
    lidx = lidx.reshape(b, c, bs, num)
    ok = ok.reshape(b, c, bs, num) & pmask[..., None]
    lidx = torch.where(ok, lidx, lidx[..., :1])
    pos = torch.where(pmask, pidx, part.n).reshape(b, -1)
    return (pos, _window_to_global(widx, lidx).reshape(b, -1, num),
            ok.reshape(b, -1, num))


def _stride1(part: FractalPartition, search, *, w: int, bs: int,
             chunk: int | None):
    """A stride-1 search (``_points_slice``) over every leaf, ``chunk``
    leaves of every cloud a step, its rows scattered to the sorted frame:
    (idx (B, n, num) int32, ok (B, n, num)); the row of a point that no
    leaf block holds has index 0 and no ok slot."""
    pos, g, ok = _chunked_slices(
        (part.leaf_start, part.leaf_vsize, part.parent_start,
         part.parent_vsize, part.is_leaf),
        lambda s: _points_slice(part, s, search=search, w=w, bs=bs), chunk)
    return (_scatter_rows(part.n, 0, pos, g).to(torch.int32),
            _scatter_rows(part.n, False, pos, ok))


def blockwise_ball_query_points(part: FractalPartition, *, radius: float,
                                num: int, w: int, bs: int,
                                chunk: int | None = None):
    """Block-wise grouping at stride 1 (PointNeXt's InvResMLP blocks):
    every valid point of every leaf is a centre, ``bs`` (the threshold th)
    centres a leaf block, and searches its leaf's parent window as
    ``blockwise_ball_query``'s sampled centres do.  Returns (idx, mask),
    (B, n, num) rows in the sorted order, row s the neighbours of point s:
    indices into the sorted arrays (an empty slot repeats the nearest) and
    the in-radius mask; the row of a point that is no centre (invalid, or
    past ``bs`` in an overflowing leaf) holds index 0 and no valid slot.
    ``chunk`` processes that many leaves of every cloud per step."""
    r2 = f32_square(radius)

    def search(q, qmask, win, wmask):
        lidx, nd2, _ = _on_blocks(
            lambda *a: kops.ball_query_blocks(*a, radius=radius, num=num),
            q, qmask, win, wmask)
        return lidx, nd2.clamp(min=0.0) <= r2

    return _stride1(part, search, w=w, bs=bs, chunk=chunk)


def blockwise_knn_points(part: FractalPartition, *, k: int, w: int, bs: int,
                         chunk: int | None = None):
    """Block-wise kNN at stride 1 (Point Transformer's blocks): every valid
    point of every leaf, ``bs`` a leaf block, finds its ``k`` nearest
    points of its leaf's parent window, itself first.  Returns (idx, mask),
    (B, n, k) rows in the sorted order as ``blockwise_ball_query_points``
    gives them: indices into the sorted arrays and which slots hold a
    neighbour (a window of fewer than ``k`` valid lanes leaves the rest
    empty, each repeating the point itself); the row of a point that is no
    query holds index 0 and no valid slot.  ``chunk`` processes that many
    leaves of every cloud per step."""
    def search(q, qmask, win, wmask):
        lidx, nd2 = _on_blocks(lambda *a: kops.knn_blocks(*a, k=k), q, win,
                               wmask)
        return lidx, nd2 < INF

    return _stride1(part, search, w=w, bs=bs, chunk=chunk)


def _knn_slice(part, sl, *, k, w):
    ls, lv, ps, pv, il, gidx, bmask = sl
    b, c, kbm = gidx.shape
    win, wmask, widx = window_from(ls, lv, ps, pv, il, part.coords,
                                   part.valid, w)
    centers = take(part.coords, gidx)
    lidx, nd2 = _on_blocks(lambda *a: kops.knn_blocks(*a, k=k),
                           _flat(centers), _flat(win), _flat(wmask))
    lidx = lidx.reshape(b, c, kbm, k)
    nd2 = nd2.reshape(b, c, kbm, k)
    ok = (nd2 < INF) & bmask[..., None]
    nd2 = nd2.clamp(min=0.0)
    cnt = ok.sum(-1).to(torch.int32)
    return _window_to_global(widx, lidx), ok, cnt, nd2


def blockwise_knn(part: FractalPartition, samp: BWSamples, *, k: int,
                  w: int, chunk: int | None = None) -> BWNeighbors:
    """Block-wise kNN of sampled centres inside their parent window."""
    g, ok, cnt, nd2 = _chunked_slices(
        _neighbor_slices(part, samp),
        lambda s: _knn_slice(part, s, k=k, w=w), chunk)
    return _compact_neighbors(samp, g, ok, cnt, nd2, k)


def _compact_neighbors(samp: BWSamples, gidx, mask, cnt, d2, num):
    k_out = samp.k_out
    b = gidx.shape[0]
    j = torch.arange(samp.block_mask.shape[-1], device=gidx.device)
    pos = torch.where(samp.block_mask,
                      samp.cum_quota[:, :-1, None].long() + j,
                      k_out).reshape(b, -1)
    return BWNeighbors(
        idx=_scatter_rows(k_out, 0, pos,
                          gidx.reshape(b, -1, num)).to(torch.int32),
        mask=_scatter_rows(k_out, False, pos, mask.reshape(b, -1, num)),
        cnt=_scatter_rows(k_out, 0, pos, cnt.reshape(b, -1)),
        d2=_scatter_rows(k_out, INF, pos, d2.reshape(b, -1, num)))


def coarse_window_ranges(part: FractalPartition, samp: BWSamples):
    """Per-leaf range [ca, cb) of coarse samples in the parent subtree
    (samples of a subtree are contiguous in the compacted array)."""
    L = part.leaf_of_slot.shape[-1]
    total_depth = max(L.bit_length() - 1, 0)
    slo, shi = subtree_slot_range(part, part.leaf_depth, part.slot_of_leaf,
                                  total_depth)
    slo = slo.clamp(0, L)
    shi = shi.clamp(0, L)
    cum_leaves = part.slot_cum_leaves.long()
    la = torch.gather(cum_leaves, 1, slo)
    lb = torch.gather(cum_leaves, 1, shi)
    # la/lb exceed ML once leaf_capacity_exceeded is set; JAX clamps the
    # gather there, so clamp explicitly.
    top = samp.cum_quota.shape[-1] - 1
    cq = samp.cum_quota.long()
    ca = torch.gather(cq, 1, la.clamp(max=top))
    cb = torch.gather(cq, 1, lb.clamp(max=top))
    return ca, cb


def _interp_slices(part: FractalPartition, samp: BWSamples, wc: int):
    """Per-leaf slice arrays (B, ML) the interpolation chunks over: each
    leaf's first candidate ``lo``, the end ``cb`` of its parent subtree's
    coarse samples, and the leaf layout."""
    ca, cb = coarse_window_ranges(part, samp)
    own = samp.cum_quota[:, :part.ml].long()
    quota = samp.quota.long()
    lo = torch.minimum(torch.maximum(own - ((wc - quota) // 2).clamp(min=0),
                                     ca),
                       torch.maximum(ca, cb - wc))
    return lo, cb, part.is_leaf, part.leaf_start, part.leaf_vsize


def _occupied(sl, bs: int):
    """(start (B, c), count (B, c)) of one leaf slice: each leaf block's
    first row in the sorted frame and its occupied lanes, a prefix of the
    block (``leaf_vsize`` capped at ``bs``; none for a slot that holds no
    leaf)."""
    _, _, il, ls, lv = sl
    return ls, torch.where(il, lv.clamp(max=bs), 0)


def _interp_slice(part, samp, sl, *, wc, bs, eps):
    """3-NN search of one leaf slice's points among its ``wc`` coarse
    candidates.  Returns (candidates (B, c, wc) into the samples; nidx
    (B, c, bs, 3) into the candidates; IDW weights (B, c, bs, 3))."""
    lo, cb, il, ls, lv = sl
    b, c = lo.shape
    j = torch.arange(wc, device=lo.device)
    cidx = lo[..., None] + j                                # (B, c, wc)
    cmask = (cidx < cb[..., None]) & il[..., None]
    cidx = cidx.clamp(0, samp.k_out - 1)
    cmask = cmask & take(samp.valid, cidx)
    cpts = take(samp.coords, cidx)                          # (B, c, wc, 3)

    fine, _, _ = leaf_from(ls, lv, il, part.coords, bs)
    nidx, nd2 = _on_blocks(lambda *a: kops.knn_blocks(*a, k=3), _flat(fine),
                           _flat(cpts), _flat(cmask))
    nidx = nidx.reshape(b, c, bs, 3)
    nd2 = nd2.reshape(b, c, bs, 3).clamp(min=0.0)
    ok = nd2 < INF
    wgt = torch.where(ok, 1.0 / (nd2 + eps), 0.0)
    wsum = wgt.sum(-1, keepdim=True)
    wgt = torch.where(wsum > 0, wgt / wsum.clamp(min=eps), 0.0)
    return cidx, nidx, wgt


def blockwise_interpolate(part: FractalPartition, samp: BWSamples,
                          feats: torch.Tensor, *, wc: int, bs: int,
                          eps: float = 1e-8, chunk: int | None = None):
    """Block-wise interpolation (paper BWI): 3-NN IDW feature propagation
    from the compacted samples back to every point, candidates restricted
    to the coarse samples of the leaf's parent subtree.

    ``feats`` (B, k_out, C).  Returns out (B, n, C), the points' blended
    features in the sorted frame (``fractal.unpermute`` maps them to the
    clouds' own order); a row that no leaf block holds stays 0.  Per leaf
    chunk (``chunk`` leaves of every cloud a step), the in-window gather
    kernel fetches each lane's three candidates' rows and the
    ``interp_blend`` kernel blends them with their weights into ``out``,
    over the occupied leaf lanes only."""
    b, n, cf = part.batch, part.n, feats.shape[-1]
    out = torch.zeros((b, n, cf), dtype=feats.dtype, device=feats.device)
    for s in kops.leaf_chunks(_interp_slices(part, samp, wc), chunk, dim=1):
        cidx, nidx, wgt = _interp_slice(part, samp, s, wc=wc, bs=bs, eps=eps)
        c = cidx.shape[1]
        vals = _on_blocks(kops.gather_blocks, _flat(take(feats, cidx)),
                          nidx.reshape(b * c, bs * 3))
        start, count = _occupied(s, bs)
        out = kops.interp_blend(out, vals, _flat(wgt), _flat(start),
                                _flat(count))
    return out


def blockwise_interpolation_weights(part: FractalPartition,
                                    samp: BWSamples, *, wc: int, bs: int,
                                    eps: float = 1e-8,
                                    chunk: int | None = None):
    """The 3-NN selection behind ``blockwise_interpolate``: (idx3 (B, n, 3)
    int32 into the compacted samples, w3 (B, n, 3) the IDW weights), rows
    in the sorted frame; 0 in both for a point that no leaf block holds."""
    def weights(s):
        cidx, nidx, wgt = _interp_slice(part, samp, s, wc=wc, bs=bs, eps=eps)
        b, c = cidx.shape[:2]
        start, count = _occupied(s, bs)
        lane = torch.arange(bs, device=start.device)
        pos = torch.where(lane < count[..., None],
                          start[..., None].long() + lane, part.n)
        sidx = torch.gather(cidx[:, :, None, :].expand(b, c, bs, wc), -1,
                            nidx.long())
        return (pos.reshape(b, -1), sidx.reshape(b, -1, 3),
                wgt.reshape(b, -1, 3))

    pos, idx3, w3 = _chunked_slices(_interp_slices(part, samp, wc), weights,
                                    chunk)
    return (_scatter_rows(part.n, 0, pos, idx3).to(torch.int32),
            _scatter_rows(part.n, 0.0, pos, w3))


def gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Block-wise gathering (paper BWGa) over the compacted index frame:
    feats (B, m, C), idx (B, ...) -> (B, ..., C).  The in-window gather
    kernel runs inside ``blockwise_interpolate``."""
    return take(feats, idx)
