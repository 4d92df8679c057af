"""Fractal: shape-aware, sorter-free point-cloud partitioning (paper Alg. 1).

Counterpart of ``repro.core.fractal``, with the batch axis written out:
where the JAX package partitions one cloud and ``vmap``s, this module takes
``(B, n, 3)`` clouds and returns a ``FractalPartition`` whose every field
has a leading ``B``.  All shapes depend only on (n, th, depth), and nothing
here reads a tensor back to the host, except the ``on_overflow="warn"``
check, which runs after the partition is complete.

The engine is level-synchronous: level ``l`` holds ``2**l`` tree nodes and
points stay contiguous by node in depth-first (DFT) order.  In
``tensor_pass`` a level costs a segment min/max, three cumulative sums and
one scatter.  Strategies differ only in the split value ``mid``:
``fractal`` (midpoint of the node's points), ``uniform`` (cell centre,
non-adaptive), ``octree`` (cell centre, adaptive), ``kdtree`` (median, by a
real per-level sort).  ``fractal`` on the card runs the hand-written level
pass of ``kernels/partition.py`` instead, field for field the same.

JAX behaviours reproduced explicitly: ``segment_min/max`` give +-inf on an
empty segment (``scatter_reduce`` seeded with +-inf); out-of-range scatter
writes are dropped (here: written to one sink slot past the end, then
sliced off).
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from repro_torch.kernels import partition as _kernel
from repro_torch.kernels.common import on_card

FRACTAL = "fractal"
UNIFORM = "uniform"
OCTREE = "octree"
KDTREE = "kdtree"
STRATEGIES = (FRACTAL, UNIFORM, OCTREE, KDTREE)
ON_OVERFLOW = ("warn", "silent")

_BIG = 3.0e38


class FractalOverflowWarning(UserWarning):
    """A partition hit its depth cap with a leaf still holding >th points."""


class FractalOverflowError(RuntimeError):
    """Raised by ``check_overflow`` on a partition that kept >th leaves."""


def default_depth(n: int, th: int, slack: int = 9, hard_cap: int = 18) -> int:
    """Static tree depth: ceil(log2(n/th)) plus slack levels."""
    if th <= 0:
        raise ValueError(f"th must be positive, got {th}")
    base = max(0, math.ceil(math.log2(max(1, n) / th))) if n > th else 0
    return min(base + (slack if base > 0 else 0), hard_cap)


def max_leaves(n: int, th: int, depth: int) -> int:
    """Static bound on the number of real leaves (see the JAX package)."""
    per_level = n // (th + 1)
    total = sum(min(2 ** l, per_level) for l in range(depth))
    return int(min(2 ** depth, total + 1))


@dataclasses.dataclass(frozen=True)
class FractalPartition:
    """Static-shape partition of B clouds; every field leads with B."""

    # Point layout (DFT order).
    perm: torch.Tensor            # (B, n) int32: sorted = x[perm]
    coords: torch.Tensor          # (B, n, 3) permuted coordinates
    valid: torch.Tensor           # (B, n) bool, permuted validity
    # Compacted leaves (DFT order), ML = max_leaves slots.
    leaf_start: torch.Tensor      # (B, ML) int32
    leaf_rsize: torch.Tensor      # (B, ML) int32 incl. trailing invalid
    leaf_vsize: torch.Tensor      # (B, ML) int32 valid points
    leaf_depth: torch.Tensor      # (B, ML) int32
    is_leaf: torch.Tensor         # (B, ML) bool
    # Search-space rule: depth >= 2 -> immediate parent; else the leaf.
    parent_start: torch.Tensor    # (B, ML) int32
    parent_rsize: torch.Tensor    # (B, ML) int32
    parent_vsize: torch.Tensor    # (B, ML) int32
    # Level-D slot bookkeeping (L = 2**depth slots).
    slot_of_leaf: torch.Tensor    # (B, ML) int32 (-1 past the real leaves)
    leaf_of_slot: torch.Tensor    # (B, L) int32 (-1 where no leaf)
    slot_cum_leaves: torch.Tensor  # (B, L+1) int32
    # Diagnostics.
    num_leaves: torch.Tensor      # (B,) int32
    traversals: torch.Tensor      # (B,) int32 levels in which a node split
    sort_passes: torch.Tensor     # (B,) int32 O(n log n) sorts (0: fractal)
    overflowed: torch.Tensor      # (B,) bool a leaf kept >th valid points
    leaf_capacity_exceeded: torch.Tensor  # (B,) bool more leaves than ML
    max_leaf_vsize: torch.Tensor  # (B,) int32

    @property
    def n(self) -> int:
        return self.perm.shape[-1]

    @property
    def ml(self) -> int:
        return self.leaf_start.shape[-1]

    @property
    def batch(self) -> int:
        return self.perm.shape[0]


def take(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-cloud gather: data (B, n, ...), idx (B, ...) -> (B, ..., ...)."""
    b = data.shape[0]
    flat = idx.reshape(b, -1).long()
    rows = torch.arange(b, device=data.device)[:, None]
    return data[rows, flat].reshape(*idx.shape, *data.shape[2:])


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 1) - x


def _segment(x, seg, num, reduce, init):
    out = torch.full((x.shape[0], num), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(1, seg, x, reduce, include_self=True)


def warn_if_overflowed(part: FractalPartition, *, th: int,
                       depth: int) -> None:
    """Host check: warn if any cloud of ``part`` overflowed.  Reads two
    small tensors back, so call it outside a timed forward."""
    if bool(part.overflowed.any()):
        warnings.warn(
            f"fractal partition overflow: a leaf kept "
            f"{int(part.max_leaf_vsize.max())} > th={th} valid points at "
            f"the depth cap (n={part.n}, depth={depth}); downstream block "
            f"ops will truncate that leaf -- raise depth/th or pre-tile the "
            f"cloud", FractalOverflowWarning, stacklevel=2)


def check_overflow(part: FractalPartition, th: int | None = None) -> None:
    """Raise ``FractalOverflowError`` if any cloud of ``part`` overflowed."""
    if bool(part.overflowed.any()):
        mx = int(part.max_leaf_vsize.max())
        raise FractalOverflowError(
            f"fractal partition overflow: a leaf kept {mx} valid points"
            + (f" > th={th}" if th is not None else "")
            + f" at the depth cap (n={part.n}); raise depth/th or pre-tile "
            f"the cloud")


def partition(coords: torch.Tensor, valid: torch.Tensor | None = None, *,
              th: int, depth: int | None = None, strategy: str = FRACTAL,
              max_leaves_: int | None = None,
              dim0: int | torch.Tensor = 0,
              on_overflow: str = "warn") -> FractalPartition:
    """Partition B clouds ``(B, n, 3)`` into <=th-point blocks in DFT order.

    ``dim0`` offsets the split-dimension cycle (level ``l`` splits on
    ``(l + dim0) % 3``): an int, or a ``(B,)`` tensor that phases each cloud
    on its own.  ``on_overflow="warn"`` warns, after the partition is built,
    when a leaf kept more than ``th`` valid points at the depth cap (a read
    back to the host); ``"silent"`` skips the check.

    ``strategy="fractal"`` on the card runs the hand-written level pass
    (``kernels.partition``, ``csrc/partition.cu``), elsewhere this module's
    ``tensor_pass``, its plain version; the two agree field by field.
    ``uniform``, ``octree`` and ``kdtree``, the paper's comparison
    baselines, run ``tensor_pass`` on every device.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if on_overflow not in ON_OVERFLOW:
        raise ValueError(f"on_overflow must be one of {ON_OVERFLOW}, "
                         f"got {on_overflow!r}")
    if coords.dim() != 3:
        raise ValueError(f"coords must be (B, n, 3), got {tuple(coords.shape)}")
    b, n = coords.shape[:2]
    dev = coords.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    if depth is None:
        depth = (default_depth(n, th, slack=0) if strategy == UNIFORM
                 else default_depth(n, th))
    if max_leaves_ is not None:
        ml = max_leaves_
    elif strategy == UNIFORM:
        ml = 2 ** depth
    else:
        ml = max_leaves(n, th, depth)
    if isinstance(dim0, torch.Tensor):
        dim0 = dim0.to(dtype=torch.int64, device=dev).reshape(b)
    pts = coords.to(torch.float32)
    vld = valid.to(torch.bool)
    dims = (dim0,) if isinstance(dim0, torch.Tensor) else ()
    if strategy == FRACTAL and on_card(pts, vld, *dims):
        part = FractalPartition(**_kernel.partition(
            pts, vld, th=th, depth=depth, ml=ml, dim0=dim0))
        if pts.requires_grad:
            part = dataclasses.replace(part, coords=take(pts, part.perm))
    else:
        part = tensor_pass(pts, vld, th=th, depth=depth, strategy=strategy,
                           ml=ml, dim0=dim0)
    if on_overflow == "warn" and strategy != UNIFORM and n > th:
        warn_if_overflowed(part, th=th, depth=depth)
    return part


def tensor_pass(pts: torch.Tensor, vld: torch.Tensor, *, th: int, depth: int,
                strategy: str, ml: int,
                dim0: int | torch.Tensor) -> FractalPartition:
    """The partition as tensor ops, ~250 of them a level: float32 ``pts``
    (B, n, 3), bool ``vld`` (B, n), an int ``dim0`` or an int64 (B,) one,
    and ``depth`` and ``ml`` resolved (see ``partition``)."""
    b, n = pts.shape[:2]
    dev = pts.device
    adaptive = strategy != UNIFORM
    needs_bbox = strategy in (UNIFORM, OCTREE)
    i64 = dict(dtype=torch.int64, device=dev)
    orig = torch.arange(n, **i64).expand(b, n)
    node = torch.zeros((b, n), **i64)
    arange_n = torch.arange(n, **i64)

    start = torch.zeros((b, 1), **i64)
    rsize = torch.full((b, 1), n, **i64)
    vsize = vld.sum(1, keepdim=True)
    exists = torch.ones((b, 1), dtype=torch.bool, device=dev)
    if needs_bbox:
        glo = torch.where(vld[..., None], pts, _BIG).amin(1)
        ghi = torch.where(vld[..., None], pts, -_BIG).amax(1)
        box_lo, box_hi = glo[:, None, :], ghi[:, None, :]   # (B, 2**l, 3)

    leaf_records = []
    traversals = torch.zeros((b,), **i64)
    sort_passes = torch.zeros((b,), **i64)
    pstart, prsize, pvsize = start, rsize, vsize

    for lvl in range(depth + 1):
        nn = 2 ** lvl
        want_split = (vsize > th if adaptive
                      else torch.ones((b, nn), dtype=torch.bool, device=dev))
        active = exists & want_split & (lvl < depth)
        is_leaf_here = exists & ~active
        leaf_records.append(
            (lvl, is_leaf_here, start, rsize, vsize, pstart, prsize, pvsize))
        if lvl == depth:
            break

        if isinstance(dim0, torch.Tensor):
            dim = (lvl + dim0) % 3                           # (B,)
            x = torch.gather(pts, 2, dim[:, None, None].expand(b, n, 1))[..., 0]
        else:
            dim = (lvl + dim0) % 3
            x = pts[:, :, dim]
        if strategy == FRACTAL:
            lo = _segment(torch.where(vld, x, _BIG), node, nn, "amin",
                          float("inf"))
            hi = _segment(torch.where(vld, x, -_BIG), node, nn, "amax",
                          float("-inf"))
            mid = (lo + hi) * 0.5
        elif strategy in (UNIFORM, OCTREE):
            if isinstance(dim, torch.Tensor):
                sel = dim[:, None, None].expand(b, nn, 1)
                mid = (torch.gather(box_lo, 2, sel)[..., 0]
                       + torch.gather(box_hi, 2, sel)[..., 0]) * 0.5
            else:
                mid = (box_lo[..., dim] + box_hi[..., dim]) * 0.5
        else:  # KDTREE: median via an honest per-level sort.
            skey = torch.where(vld, x, _BIG)
            o1 = torch.sort(skey, dim=1, stable=True).indices
            o2 = torch.sort(node.gather(1, o1), dim=1, stable=True).indices
            order = o1.gather(1, o2)                     # by (node, key)
            sorted_node = node.gather(1, order)
            pos_in_node = arange_n - start.gather(1, sorted_node)
            med_rank = (vsize.clamp(min=1) - 1) // 2
            is_med = pos_in_node == med_rank.gather(1, sorted_node)
            mid = _segment(torch.where(is_med, skey.gather(1, order), -_BIG),
                           sorted_node, nn, "amax", float("-inf"))
            sort_passes = sort_passes + 1

        traversals = traversals + active.any(1).to(torch.int64)

        node_active = active.gather(1, node)
        node_mid = mid.gather(1, node)
        # Partition key: 0 = left-valid, 1 = right-valid, 2 = invalid
        # (always last within the node; goes right iff the node splits).
        side = (x > node_mid).to(torch.int64)
        key = torch.where(vld, torch.where(node_active, side, 0), 2)
        child = torch.where(node_active, (key > 0).to(torch.int64), 0)

        # Stable segmented partition via cumulative sums (no sort).
        onehot = [(key == k).to(torch.int64) for k in range(3)]
        cnt = [_segment(o, node, nn, "sum", 0) for o in onehot]
        excl = [_exclusive_cumsum(o) for o in onehot]
        node_start = start.gather(1, node)
        rank = sum(torch.where(key == k,
                               excl[k] - excl[k].gather(1, node_start), 0)
                   for k in range(3))
        offset = (torch.where(key >= 1, cnt[0].gather(1, node), 0)
                  + torch.where(key >= 2, cnt[1].gather(1, node), 0))
        newpos = node_start + offset + rank

        def scat(a):
            if a.dim() == 3:
                return torch.zeros_like(a).scatter_(
                    1, newpos[..., None].expand_as(a), a)
            return torch.zeros_like(a).scatter_(1, newpos, a)

        pts = scat(pts)
        vld = scat(vld)
        orig = scat(orig)
        node = scat(node * 2 + child)

        # Child node state (2**(l+1)).
        idx2 = torch.arange(2 * nn, **i64)
        par = idx2 // 2
        is_left = (idx2 % 2) == 0
        l_v = cnt[0]
        r_v = torch.where(active, cnt[1], 0)
        r_r = torch.where(active, rsize - cnt[0], 0)
        l_rr = torch.where(active, l_v, rsize)     # inactive: all to child 0
        l_vv = torch.where(active, l_v, vsize)
        new_rsize = torch.where(is_left, l_rr[:, par], r_r[:, par])
        new_vsize = torch.where(is_left, l_vv[:, par], r_v[:, par])
        new_start = _exclusive_cumsum(new_rsize)
        new_exists = exists[:, par] & active[:, par]

        pstart, prsize, pvsize = start[:, par], rsize[:, par], vsize[:, par]
        if needs_bbox:
            if isinstance(dim, torch.Tensor):
                d_hot = (torch.arange(3, **i64)[None, :]
                         == dim[:, None])[:, None, :]        # (B, 1, 3)
            else:
                d_hot = (torch.arange(3, **i64) == dim)[None, None, :]
            mid_p = mid[:, par][..., None]
            box_lo = torch.where(d_hot & ~is_left[None, :, None], mid_p,
                                 box_lo[:, par])
            box_hi = torch.where(d_hot & is_left[None, :, None], mid_p,
                                 box_hi[:, par])

        start, rsize, vsize, exists = new_start, new_rsize, new_vsize, new_exists

    # ---- Fold per-level leaves into level-D slots, then compact. ----
    L = 2 ** depth
    slot_is_leaf = torch.zeros((b, L), dtype=torch.bool, device=dev)
    slot = {k: torch.zeros((b, L), **i64) for k in
            ("start", "rsize", "vsize", "depth", "pstart", "prsize",
             "pvsize")}
    for (lvl, isl, st, rs, vs, ps, prs, pvs) in leaf_records:
        slots = torch.arange(2 ** lvl, **i64) << (depth - lvl)
        # Paper rule: depth-0/1 leaves search themselves; deeper leaves use
        # their immediate parent.
        use_self = lvl <= 1
        vals = {"start": st, "rsize": rs, "vsize": vs,
                "depth": torch.full_like(st, lvl),
                "pstart": st if use_self else ps,
                "prsize": rs if use_self else prs,
                "pvsize": vs if use_self else pvs}
        slot_is_leaf[:, slots] = isl | slot_is_leaf[:, slots]
        for k, v in vals.items():
            slot[k][:, slots] = torch.where(isl, v, slot[k][:, slots])

    cum = torch.cat([torch.zeros((b, 1), **i64),
                     torch.cumsum(slot_is_leaf.to(torch.int64), 1)], 1)
    num_leaves = cum[:, -1]
    compact_idx = cum[:, :-1]
    leaf_of_slot = torch.where(slot_is_leaf, compact_idx, -1)
    # Compaction target; leaves past ML and non-leaf slots go to the sink.
    target = torch.where(slot_is_leaf, compact_idx, ml).clamp(max=ml)

    def compact(a, fill=0):
        out = torch.full((b, ml + 1), fill, dtype=a.dtype, device=dev)
        return out.scatter_(1, target, a)[:, :ml]

    i32 = lambda t: t.to(torch.int32)
    slot_ids = torch.arange(L, **i64).expand(b, L)
    return FractalPartition(
        perm=i32(orig),
        coords=pts,
        valid=vld,
        leaf_start=i32(compact(slot["start"])),
        leaf_rsize=i32(compact(slot["rsize"])),
        leaf_vsize=i32(compact(slot["vsize"])),
        leaf_depth=i32(compact(slot["depth"])),
        is_leaf=torch.arange(ml, **i64)[None, :] < num_leaves[:, None],
        parent_start=i32(compact(slot["pstart"])),
        parent_rsize=i32(compact(slot["prsize"])),
        parent_vsize=i32(compact(slot["pvsize"])),
        slot_of_leaf=i32(compact(slot_ids, fill=-1)),
        leaf_of_slot=i32(leaf_of_slot),
        slot_cum_leaves=i32(cum),
        num_leaves=i32(num_leaves),
        traversals=i32(traversals),
        sort_passes=i32(sort_passes),
        overflowed=(slot_is_leaf & (slot["vsize"] > th)).any(1),
        leaf_capacity_exceeded=num_leaves > ml,
        max_leaf_vsize=i32(torch.where(slot_is_leaf, slot["vsize"],
                                       0).amax(1)),
    )


# ---------------------------------------------------------------------------
# Block / window views (padded gathers over the DFT-contiguous layout).
# ---------------------------------------------------------------------------

def leaf_from(leaf_start, leaf_vsize, is_leaf, data, bs: int):
    """Leaf view over any subset of leaves: leaf arrays (B, c), data
    (B, n, ...) -> (view (B, c, bs, ...), mask (B, c, bs), idx (B, c, bs))."""
    n = data.shape[1]
    j = torch.arange(bs, device=data.device)
    idx = leaf_start[..., None].long() + j
    mask = is_leaf[..., None] & (j < leaf_vsize[..., None])
    idx = idx.clamp(0, n - 1)
    return take(data, idx), mask, idx


def leaf_view(part: FractalPartition, data: torch.Tensor, bs: int):
    """Per-leaf data padded to (B, ML, bs, ...); ``data`` in DFT order.
    Returns (view, mask, idx)."""
    return leaf_from(part.leaf_start, part.leaf_vsize, part.is_leaf, data,
                     bs)


def window_from(leaf_start, leaf_vsize, parent_start, parent_vsize,
                is_leaf, data, valid, w: int):
    """Search-space window over any subset of leaves (see window_view)."""
    n = data.shape[1]
    ls, lv = leaf_start.long(), leaf_vsize.long()
    ps, pv = parent_start.long(), parent_vsize.long()
    want = ls - ((w - lv) // 2).clamp(min=0)
    lo = torch.minimum(torch.maximum(want, ps),
                       torch.maximum(ps, ps + pv - w))
    j = torch.arange(w, device=data.device)
    idx = lo[..., None] + j
    mask = is_leaf[..., None] & (idx < (ps + pv)[..., None])
    mask = mask & take(valid, idx.clamp(0, n - 1))
    idx = idx.clamp(0, n - 1)
    return take(data, idx), mask, idx


def window_view(part: FractalPartition, data: torch.Tensor, w: int):
    """Per-leaf search-space window into the parent range, padded to w and
    clamped inside the parent's valid prefix.  Returns (view, mask, idx)."""
    return window_from(part.leaf_start, part.leaf_vsize, part.parent_start,
                       part.parent_vsize, part.is_leaf, data, part.valid, w)


def subtree_slot_range(part: FractalPartition, depth_arr: torch.Tensor,
                       slot: torch.Tensor, total_depth: int):
    """Level-D slot range [lo, hi) of the subtree rooted at a leaf's parent."""
    shift = (total_depth - (depth_arr.long() - 1).clamp(min=0)).clamp(min=0)
    parent_slot = (slot.long() >> shift) << shift
    return parent_slot, parent_slot + (torch.ones_like(shift) << shift)
