"""Point Transformer for semantic segmentation (Zhao, Jiang, Jia, Torr,
Koltun, ICCV 2021; ``pointtransformer_seg_repro`` of the authors'
repository), the variant ``point_transformer`` of ``models/pnn.py``:
``pnn.init`` and ``pnn.apply`` hand such a configuration to this module.

Five levels, of ``stem_width`` channels and then each stage's, each built
as published:

* ``down``: level 0's is a dense layer on the input features (stride 1);
  level l's (l >= 1) is the TransitionDown: block-wise FPS to ``rate`` of
  the finer level's points, each centre's ``stages[l - 1].nsample``
  nearest points of that level (kNN, the centre itself included), a dense
  layer on ``[p_j - p_i ; x_j]`` and a max over the neighbours;
* ``enc``: ``enc_blocks[l]`` Point Transformer blocks: ``linear1``, the
  vector-attention layer, BatchNorm and ReLU, ``linear3``, the block's
  input added, ReLU;
* ``up``: the TransitionUp onto the level, on the way back: at the last
  level ``linear1([x ; linear2(mean of the cloud's x)])``, elsewhere
  ``linear1(x_l) + interp3(linear2(x_{l+1}))`` with the 3-NN
  interpolation of ``core/bppo.py``;
* ``dec``: one more block after it, as published.

Then ``head`` and ``out``.  The vector-attention layer on C channels over
each point's k nearest neighbours j (itself included; ``stem_k`` at level
0, ``stages[l - 1].nsample`` at level l), with
``G = share_planes`` groups of C / G channels::

    q, k, v = x W_q + b_q, x W_k + b_k, x W_v + b_v
    delta_ij = Dense(3 -> C)(ReLU(BN(Dense(3 -> 3)(p_j - p_i))))
    a_ij = ReLU(BN(k_j - q_i + delta_ij))
    w_ij = Dense(C/G -> C/G)(ReLU(BN(Dense(C -> C/G)(a_ij))))
    y_i[g C/G + t] = sum_j softmax_j(w_ij)[t] (v_j + delta_ij)[g C/G + t]

The softmax runs over the valid neighbours, channel by channel; a point
with none (padding, or past th in an overflowing leaf) gets 0.

q, k and v are one matrix product a point onto [q | k | v]; everything
after it -- delta, a, the w layers, the masked softmax, the weighted sum,
and the BatchNorm and ReLU after the layer -- is ``ops.vector_attention``,
one hand-written CUDA kernel a block on the card, which reads each
neighbour's k and v rows by index and writes no (B, m, k, .) tensor.  On
the card the layer is therefore inference-only (the kernel has no backward
and raises under autograd); on the CPU its plain version differentiates.

Every block of a level sees the same points with the same k, so the
level's neighbours are found once (``bppo.blockwise_knn_points`` over the
level's partition, every valid point of a leaf a query against its leaf's
parent window) and mapped once to the clouds' order with their offsets;
every encoder and decoder block of the level reuses them.  Level l's
partition is the stage-0 plan at level 0 and the next TransitionDown's at
levels 1-3; the last level gets one of its own.  BPPO point ops only:
``point_ops="global"`` raises.

BatchNorm is in inference form.  A ``Layer`` folds it into its dense
weights; the BN on ``a_ij`` folds its scale into W_q and W_k and its shift
into b_k, and scales delta in the sum; the BN after the layer is one
affine, applied in the kernel's epilogue.

Inside a serving microbatch the forward marks its phases as
``repro_torch.obs`` spans: ``stem.mlp`` (level 0's ``down``), for the
TransitionDown onto level l ``sa<l>.sample``, ``sa<l>.group`` and
``sa<l>.mlp``; level l's partition (``sa<l+1>.plan``, ``pt4.plan`` at the
last level, ``plan`` at level 0 in the engine) and search
(``pt<l>.group``); for each block ``pt<l>.enc<j>.attn`` / ``pt<l>.dec.attn``
(the attention layer, its BatchNorm and ReLU) and ``pt<l>.enc<j>.mlp`` /
``pt<l>.dec.mlp`` (``linear1``; ``linear3``, the residual and the ReLU);
``fp.top.mlp`` (the last level's TransitionUp), ``fp<i>.mlp`` and
``fp<i>.interpolate`` (the TransitionUp onto level 3 - i); and ``head``.
It counts ``pt_searches`` and ``pt_blocks`` (``obs.tally``).

``config`` maps the published numbers (planes, blocks, nsample, strides a
level) onto a ``PNNConfig``; the preset ``pnn.point_transformer_seg`` and
the benchmark's entry build theirs with it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch import obs
from repro_torch.core import bppo
from repro_torch.core.fractal import partition, take, unpermute
from repro_torch.kernels import ops
from repro_torch.models.pnn import (BatchNorm, Dense, Layer, PNNConfig,
                                    SAStage, fp_names, sa_names)

NEG = -3.0e38


def config(*, planes, blocks, nsample, strides, share_planes=8,
           num_classes=13, n_points=289_000, in_channels=3, th=256,
           point_ops="bppo", name="point_transformer") -> PNNConfig:
    """The ``PNNConfig`` of a Point Transformer given as published, one
    entry a level: ``planes``, ``blocks`` (each encoder level's first is
    its stem layer or TransitionDown, so ``blocks[l] - 1`` Point
    Transformer blocks follow it), kNN ``nsample`` and ``strides``.  The
    TransitionDown onto level l is ``stages[l - 1]``: rate ``1 /
    strides[l]``, ``nsample[l]`` neighbours (the level's blocks search as
    many), ``planes[l]`` channels; its radius is unused."""
    return PNNConfig(
        name=name, variant="point_transformer", task="seg",
        num_classes=num_classes, n_points=n_points, in_channels=in_channels,
        stem_width=planes[0], stem_k=nsample[0],
        stages=tuple(SAStage(1.0 / s, 0.0, k, (c,)) for s, k, c in
                     zip(strides[1:], nsample[1:], planes[1:])),
        enc_blocks=tuple(b - 1 for b in blocks), share_planes=share_planes,
        norm="batchnorm", fp_widths=(), head_widths=(planes[0],),
        point_ops=point_ops, th=th)


def level_k(cfg: PNNConfig) -> tuple:
    """Each level's kNN neighbours: ``stem_k``, then each stage's."""
    return (cfg.stem_k,) + tuple(s.nsample for s in cfg.stages)


class VectorAttention(nn.Module):
    """The Point Transformer layer on ``c`` channels (module docstring)."""

    def __init__(self, c: int, share: int, generator: torch.Generator):
        super().__init__()
        if c % share:
            raise ValueError(f"{c} channels do not split into "
                             f"share_planes {share} groups")
        self.share = share
        self.q = Dense(c, c, generator)
        self.k = Dense(c, c, generator)
        self.v = Dense(c, c, generator)
        self.p1 = Layer(3, 3, generator, "batchnorm")
        self.p2 = Dense(3, c, generator)
        self.bn_a = BatchNorm(c)
        self.w1 = Layer(c, c // share, generator, "batchnorm")
        self.w2 = Dense(c // share, c // share, generator)

    def forward(self, f, nidx, mask, rel, out_scale, out_shift):
        """f (B, m, C); nidx (B, m, k) each point's neighbour rows of f;
        mask (B, m, k); rel (B, m, k, 3) their offsets; (out_scale,
        out_shift) (C,) the BatchNorm after the layer -> ReLU(BN(y))."""
        b, m, c = f.shape
        s, t = self.bn_a.affine()
        qkv = torch.addmm(
            torch.cat([self.q.b * s, self.k.b * s + t, self.v.b]),
            f.reshape(-1, c), torch.cat([self.q.w * s, self.k.w * s,
                                         self.v.w], 1)).view(b, m, 3 * c)
        p1w, p1b = self.p1.folded()
        w1w, w1b = self.w1.folded()
        return ops.vector_attention(qkv, nidx, mask, rel, p1w, p1b,
                                    self.p2.w, self.p2.b, s, w1w, w1b,
                                    self.w2.w, self.w2.b, out_scale,
                                    out_shift)


class Block(nn.Module):
    """``linear1``, the attention layer, ``bn2`` and ReLU, ``linear3``, the
    block's input added, ReLU."""

    def __init__(self, c: int, share: int, generator: torch.Generator):
        super().__init__()
        self.linear1 = Layer(c, c, generator, "batchnorm")
        self.attn = VectorAttention(c, share, generator)
        self.bn2 = BatchNorm(c)
        self.linear3 = Layer(c, c, generator, "batchnorm")


class TransitionUp(nn.Module):
    """Onto a level of ``c`` channels: from the next level's ``c_up``, or
    at the last level (``c_up`` None) from the cloud's mean."""

    def __init__(self, c: int, c_up: int | None, generator: torch.Generator):
        super().__init__()
        if c_up is None:
            self.linear1 = Layer(2 * c, c, generator, "batchnorm")
            self.linear2 = Dense(c, c, generator)
        else:
            self.linear1 = Layer(c, c, generator, "batchnorm")
            self.linear2 = Layer(c_up, c, generator, "batchnorm")


class Level(nn.Module):
    def __init__(self, c_in: int, c: int, c_up: int | None, cfg: PNNConfig,
                 enc: int, generator: torch.Generator):
        super().__init__()
        self.down = Layer(c_in, c, generator, "batchnorm")
        self.enc = nn.ModuleList(Block(c, cfg.share_planes, generator)
                                 for _ in range(enc))
        self.up = TransitionUp(c, c_up, generator)
        self.dec = nn.ModuleList([Block(c, cfg.share_planes, generator)])


class PointTransformer(nn.Module):
    def __init__(self, cfg: PNNConfig, generator: torch.Generator):
        super().__init__()
        ws = (cfg.stem_width,) + tuple(s.widths[-1] for s in cfg.stages)
        nl = len(ws)
        if len(cfg.enc_blocks) != nl:
            raise ValueError(f"enc_blocks {cfg.enc_blocks} does not give one "
                             f"count a level ({nl} levels)")
        if cfg.stem_k < 1:
            raise ValueError(f"stem_k {cfg.stem_k}: level 0 needs its kNN "
                             f"neighbours")
        if cfg.task != "seg" or cfg.norm != "batchnorm":
            raise ValueError(f"point_transformer is a segmentation net with "
                             f"BatchNorm, got task {cfg.task!r}, norm "
                             f"{cfg.norm!r}")
        self.levels = nn.ModuleList(
            Level(cfg.in_channels if l == 0 else 3 + ws[l - 1], ws[l],
                  ws[l + 1] if l + 1 < nl else None, cfg, cfg.enc_blocks[l],
                  generator)
            for l in range(nl))
        self.head = Layer(ws[0], cfg.head_widths[-1], generator, "batchnorm")
        self.out = Dense(cfg.head_widths[-1], cfg.num_classes, generator)


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _level_names(l: int, enc: int, last: bool) -> tuple:
    """(plan, search, ((attn, mlp) of each encoder block), (attn, mlp) of
    the decoder's) span names of level ``l``, made once."""
    return (f"pt{l}.plan" if last else f"sa{l + 1}.plan", f"pt{l}.group",
            tuple((f"pt{l}.enc{j}.attn", f"pt{l}.enc{j}.mlp")
                  for j in range(enc)),
            (f"pt{l}.dec.attn", f"pt{l}.dec.mlp"))


def _block(blk: Block, f, nbrs, names):
    attn_span, mlp_span = names
    with obs.span(mlp_span):
        h = blk.linear1(f)
    with obs.span(attn_span):
        h = blk.attn(h, *nbrs, *blk.bn2.affine())
    with obs.span(mlp_span):
        f = torch.relu(f + blk.linear3(h, act=False))
    obs.tally("pt_blocks")
    return f


def _neighbors(cfg: PNNConfig, l: int, part, pts):
    """Level ``l``'s one search over its partition, in the clouds' order:
    (rows (B, m, k), mask, offsets (B, m, k, 3))."""
    nidx, mask = bppo.blockwise_knn_points(
        part, k=level_k(cfg)[l], w=2 * cfg.th, bs=cfg.th,
        chunk=cfg.leaf_chunk)
    nidx = unpermute(part, take(part.perm, nidx))
    mask = unpermute(part, mask)
    obs.tally("pt_searches")
    return nidx, mask, take(pts, nidx) - pts[:, :, None, :]


def _down(cfg: PNNConfig, l: int, down: Layer, part, pts, f, n_out):
    """The TransitionDown onto level ``l`` from the finer level's points
    ``pts``, features ``f`` and partition ``part``: (samples, features)."""
    _, sample_span, group_span, mlp_span = sa_names(l)
    with obs.span(sample_span):
        samp = bppo.blockwise_fps(part, rate=cfg.stages[l - 1].rate,
                                  k_out=n_out, bs=cfg.th)
    with obs.span(group_span):
        nb = bppo.blockwise_knn(part, samp, k=cfg.stages[l - 1].nsample,
                                w=2 * cfg.th, chunk=cfg.leaf_chunk)
        nidx = take(part.perm, nb.idx)
        rel = take(pts, nidx) - samp.coords[:, :, None, :]
        grouped = torch.cat([rel, take(f, nidx)], -1)
    with obs.span(mlp_span):
        h = torch.where(nb.mask[..., None], down(grouped), NEG).amax(-2)
        f = torch.where(nb.mask.any(-1, keepdim=True), h, 0.0)
    return samp, f


def _top(up: TransitionUp, f, valid):
    """The last level's TransitionUp: ``linear1([x ; linear2(mean)])``,
    the mean over each cloud's valid points."""
    v = valid[..., None].to(f.dtype)
    mean = (f * v).sum(1) / v.sum(1).clamp(min=1.0)
    g = torch.relu(up.linear2(mean))[:, None, :].expand_as(f)
    return up.linear1(torch.cat([f, g], -1))


def apply(params: PointTransformer, cfg: PNNConfig, coords, feats, valid,
          part0=None):
    """Per-point logits (B, n, classes) of B clouds (B, n, 3); ``feats``
    (B, n, in_channels) and ``valid`` (B, n) as ``pnn.apply`` gives them;
    ``part0`` the stage-0 plan, where the engine made one."""
    if cfg.point_ops != "bppo":
        raise ValueError(f"variant 'point_transformer' runs BPPO point ops "
                         f"only, got point_ops {cfg.point_ops!r}")
    sizes = cfg.stage_sizes()
    nl = len(params.levels)
    with obs.span("stem.mlp"):
        f = params.levels[0].down(feats)
    pts, vld, part = coords, valid, part0
    levels = []        # (valid, f, partition, neighbours, decoder spans)
    samps = [None]     # the TransitionDown's samples a level
    for l, lvl in enumerate(params.levels):
        plan_span, search_span, enc_spans, dec_spans = _level_names(
            l, len(lvl.enc), l == nl - 1)
        if l:
            samp, f = _down(cfg, l, lvl.down, part, pts, f, sizes[l])
            samps.append(samp)
            pts, vld, part = samp.coords, samp.valid, None
        if part is None:
            with obs.span(plan_span):
                part = partition(pts, vld, th=cfg.th, strategy=cfg.strategy,
                                 on_overflow="silent")
        with obs.span(search_span):
            nbrs = _neighbors(cfg, l, part, pts)
        for blk, names in zip(lvl.enc, enc_spans):
            f = _block(blk, f, nbrs, names)
        levels.append((vld, f, part, nbrs, dec_spans))

    wc = max(16, int(2 * cfg.th * cfg.stages[0].rate))
    x = None
    for l in reversed(range(nl)):
        lvl = params.levels[l]
        vld, skip, part, nbrs, dec_spans = levels[l]
        if x is None:
            with obs.span("fp.top.mlp"):
                x = _top(lvl.up, skip, vld)
        else:
            interpolate_span, mlp_span = fp_names(nl - 2 - l)
            with obs.span(mlp_span):
                skip = lvl.up.linear1(skip)
                coarse = lvl.up.linear2(x)
            with obs.span(interpolate_span):
                x = skip + unpermute(part, bppo.blockwise_interpolate(
                    part, samps[l + 1], coarse, wc=wc, bs=cfg.th,
                    chunk=cfg.leaf_chunk))
        for blk in lvl.dec:
            x = _block(blk, x, nbrs, dec_spans)
    with obs.span("head"):
        return params.out(params.head(x))
