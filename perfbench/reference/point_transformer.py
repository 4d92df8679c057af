"""The plain reference of Point Transformer for segmentation (the program's
variant ``point_transformer``): its forward in plain PyTorch, float32,
over the frozen building blocks of ``reference/pnn.py`` (Fractal
partition, block-wise FPS and interpolation, dense layers, the TF32
control) and ``reference/pointnext.py`` (BatchNorm, max-pool).

Written from the published model (Zhao, Jiang, Jia, Torr, Koltun, Point
Transformer, ICCV 2021; ``model/pointtransformer/pointtransformer_seg.py``
of the authors' repository: ``PointTransformerLayer``,
``PointTransformerBlock``, ``TransitionDown``, ``TransitionUp``,
``PointTransformerSeg``), with the point ops block-parallel as the
benchmark runs them.  ``p`` are coordinates, ``x`` features; every dense
layer has a bias; ``Layer`` is dense, BatchNorm, ReLU:

* level 0: ``x = Layer(x_in)``; level l >= 1 (TransitionDown): block-wise
  FPS of ``1 / strides[l]`` of the finer level's points, each centre's
  ``nsample[l]`` nearest points in its leaf's parent window (block-wise
  kNN), ``x_c = max_j Layer([p_j - p_c ; x_j])``;
* then ``blocks[l] - 1`` blocks: ``h = Layer(x)``, ``h = ReLU(BN(PTL(h)))``,
  ``x <- ReLU(x + BN(h W + b))``;
* the Point Transformer layer PTL over each point's ``nsample[l]``
  nearest points j of its leaf's parent window (itself included):
  ``q, k, v`` dense; ``d_ij = Dense(Layer(p_j - p_i))``; ``a_ij =
  ReLU(BN(k_j - q_i + d_ij))``; ``w_ij = Dense(Layer(a_ij))`` (C -> C / G ->
  C / G, G = ``share_planes``); a softmax over the valid neighbours,
  channel by channel (0 for a point with none); ``y_i = sum_j (v_j +
  d_ij) * w_ij``, each of the G groups of C / G channels weighted by the
  same ``w_ij``.  As published, each layer runs its own search; ``record``
  sees the first of a level only, since the others repeat it (the same
  points with the same k): the work a forward needs is one search a level;
* decoder, from the last level: ``x = Layer([x ; ReLU(Dense(mean_i
  x_i))])`` (the mean over the cloud's valid points), elsewhere ``x_l =
  Layer(x_l) + interp(Layer(x_{l+1}))`` (block-wise 3-NN inverse-distance
  interpolation), each followed by one block (``_make_dec``'s 2: the
  TransitionUp and a block);
* head: ``Dense(Layer(x))`` to the classes.

BatchNorm is in inference form and computed as written, from the running
statistics.  It imports nothing of the program and nothing of JAX: the
clouds and the weights come from the benchmark.  Weights are a ``{name:
tensor}`` dict under the program's parameter names (``levels.0.down.dense.w``,
``levels.1.enc.0.attn.q.w``, ``levels.4.up.linear2.w``, ...);
``param_shapes`` lists them.
"""
from __future__ import annotations

import torch

from perfbench.reference import pnn as base
from perfbench.reference import pointnext as px
from perfbench.reference.pointnext import _layer_shapes


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def _bn_shapes(prefix, c):
    return [(f"{prefix}.g", (c,)), (f"{prefix}.b", (c,)),
            (f"{prefix}.mean", (c,)), (f"{prefix}.var", (c,))]


def _dense_shapes(prefix, din, dout):
    return [(f"{prefix}.w", (din, dout)), (f"{prefix}.b", (dout,))]


def _block_shapes(p, c, share):
    a = f"{p}.attn"
    return (_layer_shapes(f"{p}.linear1", c, c)
            + _dense_shapes(f"{a}.q", c, c) + _dense_shapes(f"{a}.k", c, c)
            + _dense_shapes(f"{a}.v", c, c) + _layer_shapes(f"{a}.p1", 3, 3)
            + _dense_shapes(f"{a}.p2", 3, c) + _bn_shapes(f"{a}.bn_a", c)
            + _layer_shapes(f"{a}.w1", c, c // share)
            + _dense_shapes(f"{a}.w2", c // share, c // share)
            + _bn_shapes(f"{p}.bn2", c) + _layer_shapes(f"{p}.linear3", c, c))


def param_shapes(cfg: dict) -> list:
    """[(name, shape)] of the network of configuration ``cfg`` (the
    benchmark's configuration file), in the program's order; ``.mean``
    and ``.var`` are BatchNorm's running statistics."""
    planes, share = cfg["planes"], cfg["share_planes"]
    out = []
    for l, c in enumerate(planes):
        p = f"levels.{l}"
        out += _layer_shapes(f"{p}.down",
                             cfg["in_channels"] if l == 0
                             else 3 + planes[l - 1], c)
        for j in range(cfg["blocks"][l] - 1):
            out += _block_shapes(f"{p}.enc.{j}", c, share)
        if l + 1 < len(planes):
            out += (_layer_shapes(f"{p}.up.linear1", c, c)
                    + _layer_shapes(f"{p}.up.linear2", planes[l + 1], c))
        else:
            out += (_layer_shapes(f"{p}.up.linear1", 2 * c, c)
                    + _dense_shapes(f"{p}.up.linear2", c, c))
        out += _block_shapes(f"{p}.dec.0", c, share)
    c = planes[0]
    return (out + _layer_shapes("head", c, c)
            + _dense_shapes("out", c, cfg["num_classes"]))


# ---------------------------------------------------------------------------
# kNN in the leaves' parent windows.
# ---------------------------------------------------------------------------

def knn_points(part, *, k, w, bs, chunk, record=None):
    """Every valid point of every leaf (``bs`` a leaf block) finds its
    ``k`` nearest points of its leaf's parent window.  Returns (idx (B, n,
    k) into the sorted arrays, mask (B, n, k)), row s for the point at
    sorted position s; an empty slot repeats the nearest (the point
    itself); a point that is no query has index 0 and no valid slot."""
    n, ml = part["n"], part["ml"]
    pos_all, g_all, ok_all = [], [], []
    for s in range(0, ml, chunk):
        sl = slice(s, min(ml, s + chunk))
        ls, lv = part["leaf_start"][:, sl], part["leaf_vsize"][:, sl]
        il = part["is_leaf"][:, sl]
        pts, pmask, pidx = base.leaf_from(ls, lv, il, part["coords"], bs)
        win, wmask, widx = base.window_from(
            ls, lv, part["parent_start"][:, sl], part["parent_vsize"][:, sl],
            il, part["coords"], part["valid"], w)
        b, c = ls.shape
        args = dict(q=pts.reshape(-1, bs, 3), window=win.reshape(-1, w, 3),
                    wmask=wmask.reshape(-1, w))
        base._rec(record, "knn_blocks", num=k, **args)
        lidx, nd2 = base.knn_blocks(args["q"], args["window"], args["wmask"],
                                    k=k)
        lidx = lidx.reshape(b, c, bs, k)
        ok = (nd2.reshape(b, c, bs, k) < base.INF) & pmask[..., None]
        lidx = torch.where(ok, lidx, lidx[..., :1])
        pos_all.append(torch.where(pmask, pidx, n).reshape(b, -1))
        g_all.append(base._window_to_global(widx, lidx).reshape(b, -1, k))
        ok_all.append(ok.reshape(b, -1, k))
    pos = torch.cat(pos_all, 1)
    return (base._scatter_rows(n, 0, pos, torch.cat(g_all, 1)),
            base._scatter_rows(n, False, pos, torch.cat(ok_all, 1)))


def blockwise_knn(part, samp, *, k, w, chunk, record=None):
    """Each sampled centre's ``k`` nearest points of its leaf's parent
    window, compacted as the samples are: (idx (B, k_out, k) into the
    sorted arrays, mask)."""
    ml = part["ml"]
    outs = []
    for s in range(0, ml, chunk):
        sl = slice(s, min(ml, s + chunk))
        gidx, bmask = samp["gidx"][:, sl], samp["block_mask"][:, sl]
        b, c, kbm = gidx.shape
        win, wmask, widx = base.window_from(
            part["leaf_start"][:, sl], part["leaf_vsize"][:, sl],
            part["parent_start"][:, sl], part["parent_vsize"][:, sl],
            part["is_leaf"][:, sl], part["coords"], part["valid"], w)
        args = dict(q=base.take(part["coords"], gidx).reshape(-1, kbm, 3),
                    window=win.reshape(-1, w, 3), wmask=wmask.reshape(-1, w))
        base._rec(record, "knn_blocks", num=k, **args)
        lidx, nd2 = base.knn_blocks(args["q"], args["window"], args["wmask"],
                                    k=k)
        ok = (nd2.reshape(b, c, kbm, k) < base.INF) & bmask[..., None]
        outs.append((base._window_to_global(widx, lidx.reshape(b, c, kbm, k)),
                     ok))
    g = torch.cat([o[0] for o in outs], 1)
    ok = torch.cat([o[1] for o in outs], 1)
    b, k_out = g.shape[0], samp["k_out"]
    j = torch.arange(samp["block_mask"].shape[-1], device=g.device)
    pos = torch.where(samp["block_mask"], samp["cum_quota"][:, :-1, None] + j,
                      k_out).reshape(b, -1)
    return (base._scatter_rows(k_out, 0, pos, g.reshape(b, -1, k)),
            base._scatter_rows(k_out, False, pos, ok.reshape(b, -1, k)))


# ---------------------------------------------------------------------------
# The Point Transformer block.
# ---------------------------------------------------------------------------

def attention(net, prefix, part, x, *, k, share, th, chunk, record=None):
    """The Point Transformer layer on the points of ``part`` (the level's
    partition) with features ``x`` (B, m, C) in the level's own order; its
    own kNN search.  Returns (B, m, C), same order."""
    nidx, mask = knn_points(part, k=k, w=2 * th, bs=th, chunk=chunk,
                            record=record)
    pts, perm = part["coords"], part["perm"]
    xs = base.take(x, perm)                       # the sorted frame
    b, m, c = xs.shape
    q = net.dense(f"{prefix}.q", xs)
    kk = net.dense(f"{prefix}.k", xs)
    v = net.dense(f"{prefix}.v", xs)
    rel = base.take(pts, nidx) - pts[:, :, None, :]
    d = net.dense(f"{prefix}.p2", net.layer(f"{prefix}.p1", rel))
    a = torch.relu(net.bn(f"{prefix}.bn_a",
                          base.take(kk, nidx) - q[:, :, None, :] + d))
    w = net.dense(f"{prefix}.w2", net.layer(f"{prefix}.w1", a))
    w = torch.softmax(torch.where(mask[..., None], w, float("-inf")), dim=2)
    w = torch.where(mask[..., None], w, 0.0)
    y = ((base.take(v, nidx) + d).reshape(b, m, k, share, c // share)
         * w[:, :, :, None, :]).sum(2).reshape(b, m, c)
    return base.take(y, px._inverse(perm))


def block(net, prefix, part, x, **kw):
    h = net.layer(f"{prefix}.linear1", x)
    h = torch.relu(net.bn(f"{prefix}.bn2",
                          attention(net, f"{prefix}.attn", part, h, **kw)))
    return torch.relu(x + net.layer(f"{prefix}.linear3", h, act=False))


# ---------------------------------------------------------------------------
# The network.
# ---------------------------------------------------------------------------

def segment(cfg: dict, weights: dict, coords, valid=None, *, tf32=False,
            chunk: int = 1024, record=None):
    """Per-point logits (B, n, classes) of B clouds (B, n, 3), whose
    coordinates are the input features, through the network of ``cfg``.
    ``chunk`` leaves at a time bound the distance tiles; it does not
    change the result."""
    th, share = cfg["th"], cfg["share_planes"]
    ks, strides = cfg["nsample"], cfg["strides"]
    nl = len(cfg["planes"])
    b, n = coords.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=coords.device)
    net = px.Net(weights, tf32)
    with base.matmul_precision(tf32), torch.no_grad():
        sizes = [n]
        for s in strides[1:]:
            sizes.append(max(1, int(round(sizes[-1] * (1.0 / s)))))
        pts, vld = coords, valid
        x = net.layer("levels.0.down", coords)
        part = base.partition(pts, vld, th=th)
        levels, samps, unrecorded = [], [None], [True] * nl

        def blocks(l, count, kind, part, x):
            for j in range(count):
                rec = record if unrecorded[l] else None
                unrecorded[l] = False
                x = block(net, f"levels.{l}.{kind}.{j}", part, x, k=ks[l],
                          share=share, th=th, chunk=chunk, record=rec)
            return x

        for l in range(nl):
            if l:
                samp = base.blockwise_fps(part, rate=1.0 / strides[l],
                                          k_out=sizes[l], bs=th,
                                          record=record)
                nidx, nmask = blockwise_knn(part, samp, k=ks[l], w=2 * th,
                                            chunk=chunk, record=record)
                centers = samp["coords"]
                rel = base.take(part["coords"], nidx) - centers[:, :, None, :]
                grouped = torch.cat(
                    [rel, base.take(base.take(x, part["perm"]), nidx)], -1)
                x = px.max_pool(net.layer(f"levels.{l}.down", grouped), nmask)
                samps.append(samp)
                pts, vld = centers, samp["valid"]
                part = base.partition(pts, vld, th=th)
            x = blocks(l, cfg["blocks"][l] - 1, "enc", part, x)
            levels.append((vld, x, part))
        wc = max(16, int(2 * th / strides[1]))
        for l in reversed(range(nl)):
            vld, skip, part = levels[l]
            up = f"levels.{l}.up"
            if l == nl - 1:
                v = vld[..., None].to(skip.dtype)
                mean = (skip * v).sum(1) / v.sum(1).clamp(min=1.0)
                g = torch.relu(net.dense(f"{up}.linear2", mean))
                x = net.layer(f"{up}.linear1", torch.cat(
                    [skip, g[:, None, :].expand_as(skip)], -1))
            else:
                interp = base.blockwise_interpolate(
                    part, samps[l + 1], net.layer(f"{up}.linear2", x), wc=wc,
                    bs=th, chunk=chunk, record=record)
                x = (net.layer(f"{up}.linear1", skip)
                     + base.take(interp, px._inverse(part["perm"])))
            x = blocks(l, 1, "dec", part, x)
        return net.dense("out", net.layer("head", x))
