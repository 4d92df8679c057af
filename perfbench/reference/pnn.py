"""The plain reference of the benchmark's PNNs: Fractal partition, the
block-parallel point ops (BPPO) and the PointNet++-style segmentation
forward, in plain PyTorch.

A frozen copy of the port's plain path (``core/fractal.py`` for the
``fractal`` strategy, ``core/bppo.py``, the plain versions in
``kernels/*.py`` and ``models/pnn.py`` for the ``pointnet2`` variant),
written against the paper's description, so a change to the program
cannot move it.  It imports nothing of the program and takes nothing the
program made: the clouds and the weights come from the benchmark.

Every float operation is a separate tensor op in a fixed order, as the
port's plain versions spell it: ``|a|^2 = (ax*ax + ay*ay) + az*az``,
``d2 = (|a|^2 + |b|^2) - 2*a.b``; top-k selection is repeated masked
argmin with the lowest lane winning ties.  Dense layers are ``x @ w + b``
in float32.  ``tf32=True`` is the benchmark's control: on the card the
matmuls run in TF32 (``torch.backends.cuda.matmul.allow_tf32``); on the
CPU, which has no TF32, each matmul's operands are rounded to TF32's 10
mantissa bits first, which is what the card's TF32 path does.

``record(name, args)``, where given, is called with the arguments of every
point-op call (FPS, ball query, kNN, in-window gather), in the layout of
the program's kernels, for ``yardstick/work.py``.

Weights are a ``{name: tensor}`` dict under the port's parameter names
(``stages.0.mlp.0.dense.w``, ...); ``param_shapes`` lists them.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

NEG = -3.0e38
INF = 3.0e38
_BIG = 3.0e38
LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def _mlp_shapes(prefix, din, widths):
    out = []
    for i, w in enumerate(widths):
        out += [(f"{prefix}.{i}.dense.w", (din, w)),
                (f"{prefix}.{i}.dense.b", (w,)),
                (f"{prefix}.{i}.ln.g", (w,)),
                (f"{prefix}.{i}.ln.b", (w,))]
        din = w
    return out, din


def param_shapes(cfg: dict) -> list:
    """[(name, shape)] of a segmentation PNN of configuration ``cfg`` (the
    benchmark's configuration file), in the port's order."""
    out, c_in = [], cfg["in_channels"]
    for i, s in enumerate(cfg["stages"]):
        o, c_in = _mlp_shapes(f"stages.{i}.mlp", c_in + 3, s["widths"])
        out += o
    skips = [cfg["in_channels"]] + [s["widths"][-1] for s in cfg["stages"][:-1]]
    up = cfg["stages"][-1]["widths"][-1]
    for i, widths in enumerate(cfg["fp_widths"]):
        o, up = _mlp_shapes(f"fp.{i}", up + skips[-(i + 1)], widths)
        out += o
    o, d = _mlp_shapes("head", up, cfg["head_widths"])
    out += o
    out += [("out.w", (d, cfg["num_classes"])), ("out.b", (cfg["num_classes"],))]
    return out


# ---------------------------------------------------------------------------
# Plain point-op building blocks.
# ---------------------------------------------------------------------------

def f32_square(x: float) -> float:
    x32 = np.float32(x)
    return float(x32 * x32)


def sqnorm(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def sqdist_rows(a, b):
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    cross = (a_[..., 0] * b_[..., 0] + a_[..., 1] * b_[..., 1]
             + a_[..., 2] * b_[..., 2])
    return (sqnorm(a)[..., :, None] + sqnorm(b)[..., None, :]) - 2.0 * cross


def argmin_extract(d, num: int):
    """The ``num`` smallest of each row by repeated masked argmin, the
    lowest lane on ties; an exhausted row gives lane 0 at ``INF``."""
    idxs, vals = [], []
    lane = torch.arange(d.shape[-1], device=d.device)
    for _ in range(num):
        v = d.amin(-1)
        i = torch.where(d == v[..., None], lane, d.shape[-1]).amin(-1)
        idxs.append(i.to(torch.int32))
        vals.append(v)
        d = torch.where(lane == i[..., None], INF, d)
    return torch.stack(idxs, -1), torch.stack(vals, -1)


def argmax_first(x):
    lane = torch.arange(x.shape[-1], device=x.device)
    m = x.amax(-1, keepdim=True)
    return torch.where(x == m, lane, x.shape[-1]).amin(-1)


def fps_blocks(coords, mask, k: int):
    """(NB, BS, 3), (NB, BS) -> (NB, k) int32 in-block picks; the first
    valid lane starts, ties go to the first maximum, and an exhausted
    block repeats its last pick (an empty block picks 0)."""
    nb, bs, _ = coords.shape
    lane = torch.arange(bs, device=coords.device)

    def d2_to(i):
        p = torch.gather(coords, 1, i[:, None, None].expand(nb, 1, 3))
        return sqnorm(coords - p)

    start = argmax_first(mask.to(torch.float32))
    mind = torch.where(mask, d2_to(start), NEG)
    mind = torch.where(lane == start[:, None], NEG, mind)
    picks, prev = [start], start
    for _ in range(k - 1):
        nxt = torch.where(mind.amax(-1) > NEG, argmax_first(mind), prev)
        mind = torch.minimum(mind, torch.where(mask, d2_to(nxt), NEG))
        mind = torch.where(lane == nxt[:, None], NEG, mind)
        picks.append(nxt)
        prev = nxt
    return torch.stack(picks, 1).to(torch.int32)


def ball_query_blocks(centers, cmask, window, wmask, *, radius, num):
    d = sqdist_rows(centers, window)
    d = torch.where(wmask[:, None, :], d, INF)
    in_r = (d <= f32_square(radius)) & wmask[:, None, :]
    cnt = torch.where(cmask, in_r.sum(-1), 0).to(torch.int32)
    idx, val = argmin_extract(d, num)
    return idx, val, cnt


def knn_blocks(queries, window, wmask, *, k):
    d = sqdist_rows(queries, window)
    d = torch.where(wmask[:, None, :], d, INF)
    return argmin_extract(d, k)


def gather_blocks(window_feats, idx):
    """(NB, W, C), (NB, M) -> (NB, M, C); an index outside [0, W) fetches
    zeros.  Differentiable in the features through ``torch.gather``."""
    nb, w, c = window_feats.shape
    ok = (idx >= 0) & (idx < w)
    safe = idx.clamp(0, w - 1).long()
    out = torch.gather(window_feats, 1,
                       safe[..., None].expand(nb, idx.shape[1], c))
    return torch.where(ok[..., None], out, 0.0)


def take(data, idx):
    """Per-cloud gather: data (B, n, ...), idx (B, ...) -> (B, ..., ...)."""
    b = data.shape[0]
    flat = idx.reshape(b, -1).long()
    rows = torch.arange(b, device=data.device)[:, None]
    return data[rows, flat].reshape(*idx.shape, *data.shape[2:])


# ---------------------------------------------------------------------------
# Fractal partition (paper Alg. 1), level-synchronous, batched.
# ---------------------------------------------------------------------------

def default_depth(n: int, th: int) -> int:
    base = max(0, math.ceil(math.log2(max(1, n) / th))) if n > th else 0
    return min(base + (9 if base > 0 else 0), 18)


def max_leaves(n: int, th: int, depth: int) -> int:
    per_level = n // (th + 1)
    total = sum(min(2 ** l, per_level) for l in range(depth))
    return int(min(2 ** depth, total + 1))


def _excl(x):
    return torch.cumsum(x, 1) - x


def _segment(x, seg, num, reduce, init):
    out = torch.full((x.shape[0], num), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(1, seg, x, reduce, include_self=True)


def partition(coords, valid, *, th: int) -> dict:
    """Partition B clouds (B, n, 3) into <= th-point leaves in depth-first
    order: each level splits every node holding more than ``th`` valid
    points at the midpoint of its points' extent on axis ``level % 3``
    (a point at the midpoint goes left; invalid points trail their node).
    Leaves at depth <= 1 search themselves, deeper ones their parent."""
    b, n = coords.shape[:2]
    dev = coords.device
    depth = default_depth(n, th)
    ml = max_leaves(n, th, depth)
    i64 = dict(dtype=torch.int64, device=dev)
    pts, vld = coords.to(torch.float32), valid.to(torch.bool)
    orig = torch.arange(n, **i64).expand(b, n)
    node = torch.zeros((b, n), **i64)
    start = torch.zeros((b, 1), **i64)
    rsize = torch.full((b, 1), n, **i64)
    vsize = vld.sum(1, keepdim=True)
    exists = torch.ones((b, 1), dtype=torch.bool, device=dev)
    pstart, prsize, pvsize = start, rsize, vsize
    records = []
    for lvl in range(depth + 1):
        nn = 2 ** lvl
        active = exists & (vsize > th) & (lvl < depth)
        records.append((lvl, exists & ~active, start, rsize, vsize,
                        pstart, prsize, pvsize))
        if lvl == depth:
            break
        x = pts[:, :, lvl % 3]
        lo = _segment(torch.where(vld, x, _BIG), node, nn, "amin",
                      float("inf"))
        hi = _segment(torch.where(vld, x, -_BIG), node, nn, "amax",
                      float("-inf"))
        mid = (lo + hi) * 0.5
        node_active = active.gather(1, node)
        side = (x > mid.gather(1, node)).to(torch.int64)
        key = torch.where(vld, torch.where(node_active, side, 0), 2)
        child = torch.where(node_active, (key > 0).to(torch.int64), 0)
        onehot = [(key == k).to(torch.int64) for k in range(3)]
        cnt = [_segment(o, node, nn, "sum", 0) for o in onehot]
        excl = [_excl(o) for o in onehot]
        node_start = start.gather(1, node)
        rank = sum(torch.where(key == k, excl[k] - excl[k].gather(1, node_start),
                               0) for k in range(3))
        offset = (torch.where(key >= 1, cnt[0].gather(1, node), 0)
                  + torch.where(key >= 2, cnt[1].gather(1, node), 0))
        newpos = node_start + offset + rank

        def scat(a):
            pos = newpos[..., None].expand_as(a) if a.dim() == 3 else newpos
            return torch.zeros_like(a).scatter_(1, pos, a)

        pts, vld, orig = scat(pts), scat(vld), scat(orig)
        node = scat(node * 2 + child)
        idx2 = torch.arange(2 * nn, **i64)
        par, is_left = idx2 // 2, (idx2 % 2) == 0
        l_v = cnt[0]
        r_v = torch.where(active, cnt[1], 0)
        r_r = torch.where(active, rsize - cnt[0], 0)
        l_rr = torch.where(active, l_v, rsize)
        l_vv = torch.where(active, l_v, vsize)
        new_rsize = torch.where(is_left, l_rr[:, par], r_r[:, par])
        new_vsize = torch.where(is_left, l_vv[:, par], r_v[:, par])
        pstart, prsize, pvsize = start[:, par], rsize[:, par], vsize[:, par]
        start, rsize, vsize = _excl(new_rsize), new_rsize, new_vsize
        exists = exists[:, par] & active[:, par]

    L = 2 ** depth
    slot_is_leaf = torch.zeros((b, L), dtype=torch.bool, device=dev)
    keys = ("start", "vsize", "depth", "pstart", "pvsize")
    slot = {k: torch.zeros((b, L), **i64) for k in keys}
    for (lvl, isl, st, rs, vs, ps, prs, pvs) in records:
        slots = torch.arange(2 ** lvl, **i64) << (depth - lvl)
        own = lvl <= 1
        vals = {"start": st, "vsize": vs, "depth": torch.full_like(st, lvl),
                "pstart": st if own else ps, "pvsize": vs if own else pvs}
        slot_is_leaf[:, slots] = isl | slot_is_leaf[:, slots]
        for k, v in vals.items():
            slot[k][:, slots] = torch.where(isl, v, slot[k][:, slots])
    cum = torch.cat([torch.zeros((b, 1), **i64),
                     torch.cumsum(slot_is_leaf.to(torch.int64), 1)], 1)
    num_leaves = cum[:, -1]
    target = torch.where(slot_is_leaf, cum[:, :-1], ml).clamp(max=ml)

    def compact(a, fill=0):
        out = torch.full((b, ml + 1), fill, dtype=a.dtype, device=dev)
        return out.scatter_(1, target, a)[:, :ml]

    return {
        "n": n, "ml": ml, "depth": depth, "perm": orig, "coords": pts,
        "valid": vld,
        "leaf_start": compact(slot["start"]),
        "leaf_vsize": compact(slot["vsize"]),
        "leaf_depth": compact(slot["depth"]),
        "is_leaf": torch.arange(ml, **i64)[None, :] < num_leaves[:, None],
        "parent_start": compact(slot["pstart"]),
        "parent_vsize": compact(slot["pvsize"]),
        "slot_of_leaf": compact(torch.arange(L, **i64).expand(b, L), fill=-1),
        "slot_cum_leaves": cum,
    }


def leaf_from(ls, lv, il, data, bs):
    n = data.shape[1]
    j = torch.arange(bs, device=data.device)
    idx = ls[..., None] + j
    mask = il[..., None] & (j < lv[..., None])
    idx = idx.clamp(0, n - 1)
    return take(data, idx), mask, idx


def window_from(ls, lv, ps, pv, il, data, valid, w):
    n = data.shape[1]
    want = ls - ((w - lv) // 2).clamp(min=0)
    lo = torch.minimum(torch.maximum(want, ps), torch.maximum(ps, ps + pv - w))
    idx = lo[..., None] + torch.arange(w, device=data.device)
    mask = il[..., None] & (idx < (ps + pv)[..., None])
    mask = mask & take(valid, idx.clamp(0, n - 1))
    idx = idx.clamp(0, n - 1)
    return take(data, idx), mask, idx


# ---------------------------------------------------------------------------
# Block-wise sampling, grouping and interpolation.
# ---------------------------------------------------------------------------

def _scatter_rows(size, fill, pos, src):
    b = pos.shape[0]
    out = torch.full((b, size + 1, *src.shape[2:]), fill, dtype=src.dtype,
                     device=src.device)
    p = pos.clamp(max=size)
    p = p.reshape(b, -1, *([1] * (src.dim() - 2))).expand_as(src)
    return out.scatter_(1, p, src)[:, :size]


def _rec(record, name, **args):
    if record is not None:
        record(name, args)


def blockwise_fps(part, *, rate, k_out, bs, record=None):
    """Fixed-rate FPS in every leaf, compacted leaf-major into k_out
    slots."""
    kbm = min(max(1, int(round(rate * bs)) + 1), bs)
    b, ml, n = part["coords"].shape[0], part["ml"], part["n"]
    dev = part["coords"].device
    pts, mask, _ = leaf_from(part["leaf_start"], part["leaf_vsize"],
                             part["is_leaf"], part["coords"], bs)
    quota = torch.round(part["leaf_vsize"].to(torch.float32) * rate)
    quota = torch.where(part["is_leaf"], quota.clamp(max=kbm), 0).long()
    fpts, fmask = pts.reshape(-1, bs, 3), mask.reshape(-1, bs)
    _rec(record, "fps_blocks", coords=fpts, mask=fmask, k=kbm)
    local = fps_blocks(fpts, fmask, kbm).reshape(b, ml, kbm).long()
    j = torch.arange(kbm, device=dev)
    bmask = j < quota[..., None]
    gidx = (part["leaf_start"][..., None] + local).clamp(0, n - 1)
    cum = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(quota, 1)], 1)
    pos = torch.where(bmask, cum[:, :-1, None] + j, k_out).reshape(b, -1)
    idx_c = _scatter_rows(k_out, 0, pos, gidx.reshape(b, -1))
    valid_c = (torch.arange(k_out, device=dev)[None, :]
               < cum[:, -1].clamp(max=k_out)[:, None])
    coords_c = take(part["coords"], idx_c) * valid_c[..., None]
    return {"gidx": gidx, "block_mask": bmask, "quota": quota,
            "cum_quota": cum, "idx": idx_c, "valid": valid_c,
            "coords": coords_c, "k_out": k_out}


def _window_to_global(widx, lidx):
    wide = widx[:, :, None, :].expand(*lidx.shape[:3], widx.shape[-1])
    return torch.gather(wide, -1, lidx.long())


def blockwise_ball_query(part, samp, *, radius, num, w, chunk, record=None):
    """Each sampled centre's ``num`` nearest points of its leaf's parent
    window, masked to the radius; an empty slot repeats the nearest."""
    r2 = f32_square(radius)
    ml = part["ml"]
    outs = []
    for s in range(0, ml, chunk):
        sl = slice(s, min(ml, s + chunk))
        gidx, bmask = samp["gidx"][:, sl], samp["block_mask"][:, sl]
        b, c, kbm = gidx.shape
        win, wmask, widx = window_from(
            part["leaf_start"][:, sl], part["leaf_vsize"][:, sl],
            part["parent_start"][:, sl], part["parent_vsize"][:, sl],
            part["is_leaf"][:, sl], part["coords"], part["valid"], w)
        centers = take(part["coords"], gidx)
        args = dict(q=centers.reshape(-1, kbm, 3),
                    cmask=bmask.reshape(-1, kbm),
                    window=win.reshape(-1, w, 3), wmask=wmask.reshape(-1, w))
        _rec(record, "ball_query_blocks", radius=radius, num=num, **args)
        lidx, nd2, _ = ball_query_blocks(args["q"], args["cmask"],
                                         args["window"], args["wmask"],
                                         radius=radius, num=num)
        lidx = lidx.reshape(b, c, kbm, num)
        nd2 = nd2.reshape(b, c, kbm, num).clamp(min=0.0)
        in_r = (nd2 <= r2) & bmask[..., None]
        lidx = torch.where(in_r, lidx, lidx[..., :1])
        outs.append((_window_to_global(widx, lidx), in_r))
    g = torch.cat([o[0] for o in outs], 1)
    in_r = torch.cat([o[1] for o in outs], 1)
    b = g.shape[0]
    k_out = samp["k_out"]
    j = torch.arange(samp["block_mask"].shape[-1], device=g.device)
    pos = torch.where(samp["block_mask"], samp["cum_quota"][:, :-1, None] + j,
                      k_out).reshape(b, -1)
    return (_scatter_rows(k_out, 0, pos, g.reshape(b, -1, num)),
            _scatter_rows(k_out, False, pos, in_r.reshape(b, -1, num)))


def coarse_window_ranges(part, samp):
    """Per leaf, the range [ca, cb) of compacted samples in the subtree of
    its parent."""
    L = part["slot_cum_leaves"].shape[-1] - 1
    total = max(L.bit_length() - 1, 0)
    shift = (total - (part["leaf_depth"] - 1).clamp(min=0)).clamp(min=0)
    lo = (part["slot_of_leaf"] >> shift) << shift
    hi = lo + (torch.ones_like(shift) << shift)
    cum = part["slot_cum_leaves"]
    la = torch.gather(cum, 1, lo.clamp(0, L))
    lb = torch.gather(cum, 1, hi.clamp(0, L))
    top = samp["cum_quota"].shape[-1] - 1
    cq = samp["cum_quota"]
    return (torch.gather(cq, 1, la.clamp(max=top)),
            torch.gather(cq, 1, lb.clamp(max=top)))


def blockwise_interpolate(part, samp, feats, *, wc, bs, chunk, eps=1e-8,
                          record=None):
    """3-NN inverse-distance interpolation of the samples' features onto
    every point, the candidates being the samples of the leaf's parent
    subtree; returns (B, n, C) in the partition's order."""
    n, ml = part["n"], part["ml"]
    b, cf = feats.shape[0], feats.shape[-1]
    ca, cb = coarse_window_ranges(part, samp)
    own = samp["cum_quota"][:, :ml]
    quota = samp["quota"]
    lo_all = torch.minimum(
        torch.maximum(own - ((wc - quota) // 2).clamp(min=0), ca),
        torch.maximum(ca, cb - wc))
    out = feats.new_zeros((b, n + 1, cf))
    for s in range(0, ml, chunk):
        sl = slice(s, min(ml, s + chunk))
        lo, hi, il = lo_all[:, sl], cb[:, sl], part["is_leaf"][:, sl]
        c = lo.shape[1]
        cidx = lo[..., None] + torch.arange(wc, device=lo.device)
        cmask = (cidx < hi[..., None]) & il[..., None]
        cidx = cidx.clamp(0, samp["k_out"] - 1)
        cmask = cmask & take(samp["valid"], cidx)
        cpts = take(samp["coords"], cidx)
        fine, fmask, fidx = leaf_from(part["leaf_start"][:, sl],
                                      part["leaf_vsize"][:, sl], il,
                                      part["coords"], bs)
        args = dict(q=fine.reshape(-1, bs, 3), window=cpts.reshape(-1, wc, 3),
                    wmask=cmask.reshape(-1, wc))
        _rec(record, "knn_blocks", num=3, **args)
        nidx, nd2 = knn_blocks(args["q"], args["window"], args["wmask"], k=3)
        nidx = nidx.reshape(b, c, bs, 3)
        nd2 = nd2.reshape(b, c, bs, 3).clamp(min=0.0)
        ok = nd2 < INF
        wgt = torch.where(ok, 1.0 / (nd2 + eps), 0.0)
        wsum = wgt.sum(-1, keepdim=True)
        wgt = torch.where(wsum > 0, wgt / wsum.clamp(min=eps), 0.0)
        gf = take(feats, cidx).reshape(b * c, wc, cf)
        gi = nidx.reshape(b * c, bs * 3)
        _rec(record, "gather_blocks", feats=gf, idx=gi)
        vals = gather_blocks(gf, gi).reshape(b, c, bs, 3, cf)
        blended = (vals * wgt[..., None]).sum(-2)
        pos = torch.where(fmask, fidx, n).reshape(b, -1, 1)
        out = out.scatter(1, pos.expand(b, pos.shape[1], cf),
                          blended.reshape(b, -1, cf))
    return out[:, :n]


# ---------------------------------------------------------------------------
# The network.
# ---------------------------------------------------------------------------

def _round_tf32(x):
    """Round float32 to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Net:
    """Dense layers, LayerNorm and MLPs over a weight dict."""

    def __init__(self, weights: dict, tf32: bool):
        self.w = weights
        self.tf32 = tf32

    def dense(self, prefix, x):
        w = self.w[f"{prefix}.w"]
        if self.tf32 and x.device.type == "cpu":
            x, w = _round_tf32(x), _round_tf32(w)
        return x @ w + self.w[f"{prefix}.b"]

    def ln(self, prefix, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        return ((x - mu) * torch.rsqrt(var + LN_EPS) * self.w[f"{prefix}.g"]
                + self.w[f"{prefix}.b"])

    def mlp(self, prefix, x, layers: int):
        for i in range(layers):
            p = f"{prefix}.{i}"
            x = torch.relu(self.ln(f"{p}.ln", self.dense(f"{p}.dense", x)))
        return x


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for the card's float32 matmuls, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def segment(cfg: dict, weights: dict, coords, valid=None, *, tf32=False,
            chunk: int = 1024, record=None):
    """Per-point logits (B, n, classes) of B clouds (B, n, 3) through the
    PointNet++-style segmentation network of ``cfg``: SA stages of
    block-wise FPS, ball query in the parent window, grouped relative
    coordinates and features, shared MLP and masked max-pool; FP stages
    of block-wise 3-NN interpolation and an MLP; then the head.  The input
    features are the coordinates.  ``chunk`` leaves at a time bound the
    distance tiles; it does not change the result."""
    th = cfg["th"]
    b, n = coords.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=coords.device)
    net = Net(weights, tf32)
    with matmul_precision(tf32), torch.no_grad():
        sizes = [n]
        for s in cfg["stages"]:
            sizes.append(max(1, int(round(sizes[-1] * s["rate"]))))
        skips = [(coords, coords, valid)]
        ctxs = []
        for i, s in enumerate(cfg["stages"]):
            pts, feats, vld = skips[-1]
            part = partition(pts, vld, th=th)
            samp = blockwise_fps(part, rate=s["rate"], k_out=sizes[i + 1],
                                 bs=th, record=record)
            nidx, nmask = blockwise_ball_query(
                part, samp, radius=s["radius"], num=s["nsample"], w=2 * th,
                chunk=chunk, record=record)
            centers = samp["coords"]
            rel = take(part["coords"], nidx) - centers[:, :, None, :]
            gmask = torch.cat([samp["valid"][..., None], nmask[..., 1:]], -1)
            gfeats = torch.cat([rel, take(take(feats, part["perm"]), nidx)],
                               -1)
            h = net.mlp(f"stages.{i}.mlp", gfeats, len(s["widths"]))
            h = torch.where(gmask[..., None], h, -3.0e38)
            pooled = torch.where(gmask.any(-1, keepdim=True), h.amax(-2), 0.0)
            ctxs.append((part, samp))
            skips.append((centers, pooled, samp["valid"]))
        up = skips[-1][1]
        wc = max(16, int(2 * th * cfg["stages"][0]["rate"]))
        for i, widths in enumerate(cfg["fp_widths"]):
            lvl = len(cfg["stages"]) - 1 - i
            part, samp = ctxs[lvl]
            interp = blockwise_interpolate(part, samp, up, wc=wc, bs=th,
                                           chunk=chunk, record=record)
            merged = torch.cat([interp, take(skips[lvl][1], part["perm"])], -1)
            inv = torch.empty_like(part["perm"]).scatter_(
                1, part["perm"], torch.arange(part["n"], device=merged.device)
                .expand_as(part["perm"]).contiguous())
            up = net.mlp(f"fp.{i}", take(merged, inv), len(widths))
        h = net.mlp("head", up, len(cfg["head_widths"]))
        return net.dense("out", h)
