"""The plain reference of PointNeXt with InvResMLP blocks (PointNeXt-XL and
its kin, the program's variant ``pointnext_invres``): its segmentation
forward in plain PyTorch, float32, over the frozen building blocks of
``reference/pnn.py`` (Fractal partition, block-wise FPS, ball query and
interpolation, dense layers, the TF32 control).

Written from the published architecture (Qian et al., PointNeXt: Revisiting
PointNet++ with Improved Training and Scaling Strategies, NeurIPS 2022;
``openpoints/models/backbone/pointnext.py``: ``PointNextEncoder``,
``SetAbstraction``, ``InvResMLP``, ``LocalAggregation``,
``PointNextDecoder``; ``SegHead``), with the point ops block-parallel as
the benchmark runs them.  ``p`` are coordinates, ``f`` features:

* stem: ``f = f_in @ W + b``, no norm, no activation; level 0's skip;
* SA stage i: block-wise FPS of ``rate`` * n centres, block-wise ball query
  of ``nsample`` within ``radius``, ``h = ReLU(BN([(p_j - p_c) / r, f_j] @
  W + b))`` and ``f_c = max_j h``;
* then ``blocks[i]`` InvResMLP blocks on the stage's own points at radius
  ``radius_scaling * r``, every valid point a centre that searches its
  leaf's parent window (stride 1): ``g = max_j ReLU(BN([(p_j - p_i) /
  (2r), f_j] @ W_la + b))``, ``f <- ReLU(f + BN(ReLU(BN(g @ W_1 + b)) @
  W_2 + b))``.  As published, each block runs its own neighbour search;
  ``record`` sees the first of a stage only, since the others repeat it
  (the same points at the same radius): the work a forward needs is one
  search a stage;
* FP stage: 3-NN inverse-distance interpolation onto the finer level,
  concatenated with its skip, then dense-BN-ReLU layers;
* head: dense-BN-ReLU layers, then a dense layer to the classes.

BatchNorm is in inference form and computed as written: ``(x - mean) *
rsqrt(var + eps) * g + b`` from the running statistics ``mean`` and
``var``.  It imports nothing of the program and nothing of JAX: the clouds
and the weights come from the benchmark.

Weights are a ``{name: tensor}`` dict under the program's parameter names
(``stem.w``, ``stages.0.mlp.0.dense.w``, ``stages.0.mlp.0.bn.var``,
``stages.0.blocks.1.pw1.dense.w``, ...); ``param_shapes`` lists them.
"""
from __future__ import annotations

import torch

from perfbench.reference import pnn as base

BN_EPS = 1e-5


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def _layer_shapes(prefix, din, dout):
    return [(f"{prefix}.dense.w", (din, dout)), (f"{prefix}.dense.b", (dout,)),
            (f"{prefix}.bn.g", (dout,)), (f"{prefix}.bn.b", (dout,)),
            (f"{prefix}.bn.mean", (dout,)), (f"{prefix}.bn.var", (dout,))]


def _mlp_shapes(prefix, din, widths):
    out = []
    for i, w in enumerate(widths):
        out += _layer_shapes(f"{prefix}.{i}", din, w)
        din = w
    return out, din


def param_shapes(cfg: dict) -> list:
    """[(name, shape)] of the network of configuration ``cfg`` (the
    benchmark's configuration file), in the program's order; ``.mean``
    and ``.var`` are BatchNorm's running statistics."""
    c0 = cfg["stem_width"]
    out = [("stem.w", (cfg["in_channels"], c0)), ("stem.b", (c0,))]
    c_in = c0
    for i, (s, blocks) in enumerate(zip(cfg["stages"], cfg["blocks"])):
        o, c_in = _mlp_shapes(f"stages.{i}.mlp", c_in + 3, s["widths"])
        out += o
        for j in range(blocks):
            p = f"stages.{i}.blocks.{j}"
            mid = c_in * cfg["expansion"]
            out += (_layer_shapes(f"{p}.la", c_in + 3, c_in)
                    + _layer_shapes(f"{p}.pw1", c_in, mid)
                    + _layer_shapes(f"{p}.pw2", mid, c_in))
    skips = [c0] + [s["widths"][-1] for s in cfg["stages"][:-1]]
    up = cfg["stages"][-1]["widths"][-1]
    for i, widths in enumerate(cfg["fp_widths"]):
        o, up = _mlp_shapes(f"fp.{i}", up + skips[-(i + 1)], widths)
        out += o
    o, d = _mlp_shapes("head", up, cfg["head_widths"])
    out += o
    k = cfg["num_classes"]
    return out + [("out.w", (d, k)), ("out.b", (k,))]


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

class Net(base.Net):
    """Dense layers (``base.Net.dense``, TF32 control included) with
    BatchNorm."""

    def bn(self, prefix, x):
        w = self.w
        return ((x - w[f"{prefix}.mean"])
                * torch.rsqrt(w[f"{prefix}.var"] + BN_EPS) * w[f"{prefix}.g"]
                + w[f"{prefix}.b"])

    def layer(self, prefix, x, act=True):
        x = self.bn(f"{prefix}.bn", self.dense(f"{prefix}.dense", x))
        return torch.relu(x) if act else x

    def mlp(self, prefix, x, layers: int):
        for i in range(layers):
            x = self.layer(f"{prefix}.{i}", x)
        return x


def max_pool(h, gmask):
    """Max over the valid neighbours; 0 where a centre has none."""
    h = torch.where(gmask[..., None], h, -3.0e38)
    return torch.where(gmask.any(-1, keepdim=True), h.amax(-2), 0.0)


# ---------------------------------------------------------------------------
# Stride-1 grouping.
# ---------------------------------------------------------------------------

def ball_query_points(part, *, radius, num, w, bs, chunk, record=None):
    """Every valid point of every leaf (``bs`` a leaf block) searches its
    leaf's parent window for its ``num`` nearest points, masked to the
    radius (an empty slot repeats the nearest, the point itself).
    Returns (idx (B, n, num) into the sorted arrays, mask (B, n, num)),
    row s for the point at sorted position s; a point that is no centre
    has index 0 and no valid slot."""
    r2 = base.f32_square(radius)
    n, ml = part["n"], part["ml"]
    pos_all, g_all, in_all = [], [], []
    for s in range(0, ml, chunk):
        sl = slice(s, min(ml, s + chunk))
        ls, lv = part["leaf_start"][:, sl], part["leaf_vsize"][:, sl]
        il = part["is_leaf"][:, sl]
        pts, pmask, pidx = base.leaf_from(ls, lv, il, part["coords"], bs)
        win, wmask, widx = base.window_from(
            ls, lv, part["parent_start"][:, sl], part["parent_vsize"][:, sl],
            il, part["coords"], part["valid"], w)
        b, c = ls.shape
        args = dict(q=pts.reshape(-1, bs, 3), cmask=pmask.reshape(-1, bs),
                    window=win.reshape(-1, w, 3), wmask=wmask.reshape(-1, w))
        base._rec(record, "ball_query_blocks", radius=radius, num=num, **args)
        lidx, nd2, _ = base.ball_query_blocks(
            args["q"], args["cmask"], args["window"], args["wmask"],
            radius=radius, num=num)
        lidx = lidx.reshape(b, c, bs, num)
        nd2 = nd2.reshape(b, c, bs, num).clamp(min=0.0)
        in_r = (nd2 <= r2) & pmask[..., None]
        lidx = torch.where(in_r, lidx, lidx[..., :1])
        pos_all.append(torch.where(pmask, pidx, n).reshape(b, -1))
        g_all.append(base._window_to_global(widx, lidx).reshape(b, -1, num))
        in_all.append(in_r.reshape(b, -1, num))
    pos = torch.cat(pos_all, 1)
    return (base._scatter_rows(n, 0, pos, torch.cat(g_all, 1)),
            base._scatter_rows(n, False, pos, torch.cat(in_all, 1)))


def _inverse(perm):
    n = perm.shape[1]
    return torch.empty_like(perm).scatter_(
        1, perm, torch.arange(n, device=perm.device).expand_as(perm)
        .contiguous())


def inv_res_block(net, prefix, part, f, *, radius, num, th, chunk,
                  record=None):
    """One InvResMLP block on the points of ``part`` (the level's
    partition) with features ``f`` (B, n, C) in the level's own order;
    its own neighbour search.  Returns the new features, same order."""
    nidx, nmask = ball_query_points(part, radius=radius, num=num, w=2 * th,
                                    bs=th, chunk=chunk, record=record)
    pts, perm = part["coords"], part["perm"]
    rel = (base.take(pts, nidx) - pts[:, :, None, :]) / radius
    grouped = torch.cat([rel, base.take(base.take(f, perm), nidx)], -1)
    g = max_pool(net.layer(f"{prefix}.la", grouped), nmask)
    h = net.layer(f"{prefix}.pw2", net.layer(f"{prefix}.pw1", g), act=False)
    out = torch.relu(base.take(f, perm) + h)
    return base.take(out, _inverse(perm))


# ---------------------------------------------------------------------------
# The network.
# ---------------------------------------------------------------------------

def segment(cfg: dict, weights: dict, coords, valid=None, *, tf32=False,
            chunk: int = 1024, record=None):
    """Per-point logits (B, n, classes) of B clouds (B, n, 3), whose
    coordinates are the input features, through the network of ``cfg``.
    ``chunk`` leaves at a time bound the distance tiles; it does not
    change the result."""
    th = cfg["th"]
    b, n = coords.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=coords.device)
    net = Net(weights, tf32)
    with base.matmul_precision(tf32), torch.no_grad():
        sizes = [n]
        for s in cfg["stages"]:
            sizes.append(max(1, int(round(sizes[-1] * s["rate"]))))
        skips = [(coords, net.dense("stem", coords), valid)]
        ctxs = []
        part = base.partition(coords, valid, th=th)
        for i, (s, blocks) in enumerate(zip(cfg["stages"], cfg["blocks"])):
            _, feats, _ = skips[-1]
            samp = base.blockwise_fps(part, rate=s["rate"], k_out=sizes[i + 1],
                                      bs=th, record=record)
            nidx, nmask = base.blockwise_ball_query(
                part, samp, radius=s["radius"], num=s["nsample"], w=2 * th,
                chunk=chunk, record=record)
            centers = samp["coords"]
            rel = ((base.take(part["coords"], nidx) - centers[:, :, None, :])
                   / s["radius"])
            gmask = torch.cat([samp["valid"][..., None], nmask[..., 1:]], -1)
            grouped = torch.cat(
                [rel, base.take(base.take(feats, part["perm"]), nidx)], -1)
            pooled = max_pool(net.mlp(f"stages.{i}.mlp", grouped,
                                      len(s["widths"])), gmask)
            ctxs.append((part, samp))
            # the level's partition: the blocks' and the next stage's
            part = base.partition(centers, samp["valid"], th=th)
            for j in range(blocks):
                pooled = inv_res_block(
                    net, f"stages.{i}.blocks.{j}", part, pooled,
                    radius=s["radius"] * cfg["radius_scaling"],
                    num=s["nsample"], th=th, chunk=chunk,
                    record=record if j == 0 else None)
            skips.append((centers, pooled, samp["valid"]))
        up = skips[-1][1]
        wc = max(16, int(2 * th * cfg["stages"][0]["rate"]))
        for i, widths in enumerate(cfg["fp_widths"]):
            lvl = len(cfg["stages"]) - 1 - i
            part, samp = ctxs[lvl]
            interp = base.blockwise_interpolate(part, samp, up, wc=wc, bs=th,
                                                chunk=chunk, record=record)
            skip = base.take(skips[lvl][1], part["perm"])
            merged = torch.cat([interp, skip], -1)
            up = net.mlp(f"fp.{i}", base.take(merged, _inverse(part["perm"])),
                         len(widths))
        h = net.mlp("head", up, len(cfg["head_widths"]))
        return net.dense("out", h)
