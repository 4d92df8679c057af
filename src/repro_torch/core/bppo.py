"""Block-Parallel Point Operations (BPPO) -- paper section IV-B.

Counterpart of ``repro.core.bppo`` with the batch axis written out: every
op takes a batched ``FractalPartition`` (fields ``(B, ...)``) and returns
fields with a leading ``B``.  Each op is a *plan* (window, quota and
compaction index math, plain tensor ops here) around an *execute* step
that goes through ``kernels.ops``: the kernels see the ``B * ML`` leaf
blocks of all clouds at once, so each launches once per stage.

All ops work in the permuted (DFT) frame: indices index ``part.coords``;
map back with ``part.perm``.  JAX's dropped out-of-range scatter writes go
to one sink slot past the end, which is then sliced off; where JAX relied
on clamping an out-of-range gather, the index is clamped explicitly.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fractal import (FractalPartition, leaf_from, leaf_view,
                                      subtree_slot_range, take, window_from)
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

    local = kops.fps_blocks(_flat(pts), _flat(mask), k=kbm).reshape(b, ml, kbm)
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
    lidx, nd2, cnt = kops.ball_query_blocks(
        _flat(centers), _flat(bmask), _flat(win), _flat(wmask),
        radius=radius, num=num)
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


def _knn_slice(part, sl, *, k, w):
    ls, lv, ps, pv, il, gidx, bmask = sl
    b, c, kbm = gidx.shape
    win, wmask, widx = window_from(ls, lv, ps, pv, il, part.coords,
                                   part.valid, w)
    centers = take(part.coords, gidx)
    lidx, nd2 = kops.knn_blocks(_flat(centers), _flat(win), _flat(wmask),
                                k=k)
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


def _interp_slice(part, samp, feats, sl, *, wc, bs, eps):
    """One leaf slice of block-wise interpolation; returns the scatter
    payload (positions, blended features, sample indices, weights)."""
    n = part.n
    lo, cb, il, ls, lv = sl
    b, c = lo.shape
    j = torch.arange(wc, device=lo.device)
    cidx = lo[..., None] + j                                # (B, c, wc)
    cmask = (cidx < cb[..., None]) & il[..., None]
    cidx = cidx.clamp(0, samp.k_out - 1)
    cmask = cmask & take(samp.valid, cidx)
    cpts = take(samp.coords, cidx)                          # (B, c, wc, 3)

    fine, fmask, fidx = leaf_from(ls, lv, il, part.coords, bs)
    nidx, nd2 = kops.knn_blocks(_flat(fine), _flat(cpts), _flat(cmask), k=3)
    nidx = nidx.reshape(b, c, bs, 3)
    nd2 = nd2.reshape(b, c, bs, 3).clamp(min=0.0)
    ok = nd2 < INF
    wgt = torch.where(ok, 1.0 / (nd2 + eps), 0.0)
    wsum = wgt.sum(-1, keepdim=True)
    wgt = torch.where(wsum > 0, wgt / wsum.clamp(min=eps), 0.0)
    samp_idx = torch.gather(cidx[:, :, None, :].expand(b, c, bs, wc), -1,
                            nidx.long())                    # into samples
    cf = feats.shape[-1]
    vals = kops.gather_blocks(_flat(take(feats, cidx)),
                              nidx.reshape(b * c, bs * 3))
    vals = vals.reshape(b, c, bs, 3, cf)
    blended = (vals * wgt[..., None]).sum(-2)               # (B, c, bs, C)
    flat_pos = torch.where(fmask, fidx, n).reshape(b, -1)
    return flat_pos, blended, samp_idx, wgt


def blockwise_interpolate(part: FractalPartition, samp: BWSamples,
                          feats: torch.Tensor, *, wc: int, bs: int,
                          eps: float = 1e-8, chunk: int | None = None):
    """Block-wise interpolation (paper BWI): 3-NN IDW feature propagation
    from the compacted samples back to every point, candidates restricted
    to the coarse samples of the leaf's parent subtree.

    ``feats`` (B, k_out, C).  Returns (out (B, n, C) in sorted order,
    idx3 (B, n, 3), w3 (B, n, 3)).  ``chunk`` runs that many leaves per
    step, scattering each into the outputs."""
    n, ml = part.n, part.ml
    b = part.batch
    cf = feats.shape[-1]
    dev = feats.device
    ca, cb = coarse_window_ranges(part, samp)
    own = samp.cum_quota[:, :ml].long()
    quota = samp.quota.long()
    lo = torch.minimum(torch.maximum(own - ((wc - quota) // 2).clamp(min=0),
                                     ca),
                       torch.maximum(ca, cb - wc))
    sl = (lo, cb, part.is_leaf, part.leaf_start, part.leaf_vsize)

    # One sink row past the end takes the padded (dropped) positions.
    out = torch.zeros((b, n + 1, cf), dtype=feats.dtype, device=dev)
    idx3 = torch.zeros((b, n + 1, 3), dtype=torch.int64, device=dev)
    w3 = torch.zeros((b, n + 1, 3), dtype=torch.float32, device=dev)
    for s in kops.leaf_chunks(sl, chunk, dim=1):
        flat_pos, blended, samp_idx, wgt = _interp_slice(
            part, samp, feats, s, wc=wc, bs=bs, eps=eps)
        p = flat_pos[..., None]
        out.scatter_(1, p.expand(b, p.shape[1], cf), blended.reshape(b, -1, cf))
        idx3.scatter_(1, p.expand(b, p.shape[1], 3), samp_idx.reshape(b, -1, 3))
        w3.scatter_(1, p.expand(b, p.shape[1], 3),
                    wgt.to(torch.float32).reshape(b, -1, 3))
    return out[:, :n], idx3[:, :n].to(torch.int32), w3[:, :n]


def gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Block-wise gathering (paper BWGa) over the compacted index frame:
    feats (B, m, C), idx (B, ...) -> (B, ..., C).  The in-window gather
    kernel runs inside ``blockwise_interpolate``."""
    return take(feats, idx)
