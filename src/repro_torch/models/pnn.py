"""Point-based neural networks (paper Table I workloads) in PyTorch.

Counterpart of ``repro.models.pnn`` with the batch axis written out:
``apply`` takes ``(B, n, 3)`` clouds and returns ``(B, n, classes)`` (seg)
or ``(B, classes)`` (cls).  Parameters are ``nn.Module``s whose attribute
names and list positions mirror the JAX parameter tree, so
``repro_torch.convert`` can copy one into the other; a dense layer keeps
the JAX layout ``x @ w + b`` with ``w`` of shape ``(din, dout)``.

Two kinds of point ops: ``point_ops="bppo"``, Fractal partition +
block-parallel point ops, whose execute steps run the hand-written kernels
on the card and their plain versions on the CPU; and ``"global"``, the
O(n^2) baseline of ``core/ref.py`` (the paper's "Original"), plain tensor
ops on either device, as the JAX package computes it.

Variants: ``pointnet2`` (group -> shared MLP -> max-pool), ``pointnext``
(+ inverted-residual MLP blocks after pooling), ``pointvector`` (learned
per-neighbour gating before pooling).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import bppo, ref
from repro_torch.core.fractal import partition, take


@dataclasses.dataclass(frozen=True)
class SAStage:
    rate: float          # sampling rate (one fixed rate per stage)
    radius: float
    nsample: int
    widths: tuple        # MLP widths applied to grouped features


@dataclasses.dataclass(frozen=True)
class PNNConfig:
    name: str = "pointnet2"
    variant: str = "pointnet2"       # pointnet2 | pointnext | pointvector
    task: str = "cls"                # cls | seg
    num_classes: int = 6
    n_points: int = 1024
    in_channels: int = 3
    stages: tuple = (
        SAStage(0.25, 0.2, 16, (32, 32, 64)),
        SAStage(0.25, 0.4, 16, (64, 64, 128)),
    )
    fp_widths: tuple = ((128, 64), (64, 64))   # seg only, reversed order
    head_widths: tuple = (128,)
    point_ops: str = "global"        # global | bppo
    th: int = 64                     # Fractal threshold
    strategy: str = "fractal"        # partition strategy, every stage
    num_blocks: int = 1              # extra residual blocks (pointnext)
    leaf_chunk: int | None = None    # leaves per step (large scale)

    def stage_sizes(self):
        sizes = [self.n_points]
        for s in self.stages:
            sizes.append(max(1, int(round(sizes[-1] * s.rate))))
        return sizes


# ---------------------------------------------------------------------------
# Parameter modules (attribute names mirror the JAX parameter tree).
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    def __init__(self, din: int, dout: int, generator: torch.Generator):
        super().__init__()
        scale = (2.0 / (din + dout)) ** 0.5
        self.w = nn.Parameter(
            torch.randn((din, dout), generator=generator) * scale)
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        self.b = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)   # population, as jnp.var
        return (x - mu) * torch.rsqrt(var + self.eps) * self.g + self.b


class Layer(nn.Module):
    def __init__(self, din: int, dout: int, generator: torch.Generator):
        super().__init__()
        self.dense = Dense(din, dout, generator)
        self.ln = LayerNorm(dout)


class MLP(nn.ModuleList):
    """A list of (dense, ln) layers, each followed by ReLU."""

    def __init__(self, din: int, widths, generator: torch.Generator):
        layers = []
        for w in widths:
            layers.append(Layer(din, w, generator))
            din = w
        super().__init__(layers)

    def forward(self, x):
        for layer in self:
            x = torch.relu(layer.ln(layer.dense(x)))
        return x


class Stage(nn.Module):
    def __init__(self, cfg: PNNConfig, c_in: int, s: SAStage,
                 generator: torch.Generator):
        super().__init__()
        self.mlp = MLP(c_in + 3, s.widths, generator)
        if cfg.variant == "pointvector":
            self.vec = Dense(c_in + 3, s.widths[-1], generator)
        if cfg.variant == "pointnext":
            self.res = nn.ModuleList(
                MLP(s.widths[-1], (2 * s.widths[-1], s.widths[-1]), generator)
                for _ in range(cfg.num_blocks))


class PNN(nn.Module):
    def __init__(self, cfg: PNNConfig, generator: torch.Generator):
        super().__init__()
        stages, c_in = [], cfg.in_channels
        for s in cfg.stages:
            stages.append(Stage(cfg, c_in, s, generator))
            c_in = s.widths[-1]
        self.stages = nn.ModuleList(stages)
        fp = []
        if cfg.task == "seg":
            skip_dims = ([cfg.in_channels]
                         + [s.widths[-1] for s in cfg.stages[:-1]])
            up_dim = cfg.stages[-1].widths[-1]
            for i, widths in enumerate(cfg.fp_widths):
                fp.append(MLP(up_dim + skip_dims[-(i + 1)], widths, generator))
                up_dim = widths[-1]
            head_in = up_dim
        else:
            head_in = cfg.stages[-1].widths[-1]
        self.fp = nn.ModuleList(fp)
        self.head = MLP(head_in, cfg.head_widths, generator)
        self.out = Dense(cfg.head_widths[-1], cfg.num_classes, generator)


def init(cfg: PNNConfig, generator: torch.Generator | None = None,
         device: str | torch.device = "cpu") -> PNN:
    """Random weights from ``generator`` (a CPU ``torch.Generator``; seed 0
    when None), moved to ``device``.  torch and jax.random draw different
    numbers from one seed: parity tests carry JAX weights over with
    ``repro_torch.convert`` instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return PNN(cfg, generator).to(device)


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

def _stage_points(cfg: PNNConfig, stage: SAStage, coords, feats, valid,
                  n_out, part=None):
    """One sampling + grouping + gathering round over B clouds.  Returns
    (centers (B, n_out, 3), grouped (B, n_out, nsample, C+3), gmask,
    new_valid, ctx); ``part`` optionally supplies a precomputed partition
    of (coords, valid) -- the serving plan (bppo only)."""
    if cfg.point_ops == "global":
        sidx, svalid = ref.fps(coords, valid, n_out)
        centers = take(coords, sidx)
        nidx, cnt = ref.ball_query(coords, valid, centers, svalid,
                                   stage.radius, stage.nsample)
        slot = torch.arange(stage.nsample, device=coords.device)
        gmask = slot < cnt.clamp(max=stage.nsample)[..., None]
        gmask = gmask & svalid[..., None]
        gmask = torch.cat([svalid[..., None], gmask[..., 1:]], -1)
        rel = take(coords, nidx) - centers[:, :, None, :]
        gfeats = torch.cat([rel, take(feats, nidx)], -1)
        ctx = {"mode": "global", "coords": coords, "centers": centers,
               "svalid": svalid}
        return centers, gfeats, gmask, svalid, ctx
    if part is None:
        part = partition(coords, valid, th=cfg.th, strategy=cfg.strategy,
                         on_overflow="silent")
    samp = bppo.blockwise_fps(part, rate=stage.rate, k_out=n_out, bs=cfg.th)
    nb = bppo.blockwise_ball_query(part, samp, radius=stage.radius,
                                   num=stage.nsample, w=2 * cfg.th,
                                   chunk=cfg.leaf_chunk)
    feats_sorted = take(feats, part.perm)
    centers = samp.coords
    rel = bppo.gather(part.coords, nb.idx) - centers[:, :, None, :]
    gmask = torch.cat([samp.valid[..., None], nb.mask[..., 1:]], -1)
    gfeats = torch.cat([rel, bppo.gather(feats_sorted, nb.idx)], -1)
    return centers, gfeats, gmask, samp.valid, {"mode": "bppo", "part": part,
                                                "samp": samp}


def _propagate(cfg: PNNConfig, ctx, coarse_feats, fine_feats):
    """FP stage: interpolate coarse feats onto the fine cloud (3-NN IDW)."""
    if ctx["mode"] == "global":
        out, _, _ = ref.interpolate_3nn(ctx["coords"], ctx["centers"],
                                        ctx["svalid"], coarse_feats)
        return torch.cat([out, fine_feats], -1)
    part, samp = ctx["part"], ctx["samp"]
    wc = max(16, int(2 * cfg.th * cfg.stages[0].rate))
    out_sorted, _, _ = bppo.blockwise_interpolate(
        part, samp, coarse_feats, wc=wc, bs=cfg.th, chunk=cfg.leaf_chunk)
    merged = torch.cat([out_sorted, take(fine_feats, part.perm)], -1)
    # back to the fine cloud's original order
    b, n = part.batch, part.n
    ar = torch.arange(n, device=merged.device).expand(b, n)
    inv = torch.zeros((b, n), dtype=torch.int64, device=merged.device)
    inv.scatter_(1, part.perm.long(), ar)
    return take(merged, inv)


def _aggregate(stage_p: Stage, gfeats, gmask, variant):
    h = stage_p.mlp(gfeats)                                # (B, m, ns, C')
    if variant == "pointvector":
        h = h * torch.sigmoid(stage_p.vec(gfeats))
    h = torch.where(gmask[..., None], h, -3.0e38)
    pooled = h.amax(-2)
    pooled = torch.where(gmask.any(-1, keepdim=True), pooled, 0.0)
    if variant == "pointnext":
        for blk in stage_p.res:
            pooled = pooled + blk(pooled)
    return pooled


def apply(params: PNN, cfg: PNNConfig, coords: torch.Tensor,
          feats: torch.Tensor | None = None, valid: torch.Tensor | None = None,
          part0=None):
    """Forward of B clouds ``(B, n, 3)``.

    cls: (B, num_classes) logits.  seg: (B, n, num_classes) per point.
    ``part0`` optionally injects a precomputed stage-0 ``FractalPartition``
    of (coords, valid), as the serving plan cache does (bppo only; the
    global ops ignore it)."""
    if cfg.point_ops not in ("bppo", "global"):
        raise ValueError(f"point_ops must be 'bppo' or 'global', got "
                         f"{cfg.point_ops!r}")
    b, n = coords.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=coords.device)
    if feats is None:
        feats = coords
    sizes = cfg.stage_sizes()
    skips = [(coords, feats, valid)]
    ctxs = []
    for i, s in enumerate(cfg.stages):
        centers, gfeats, gmask, svalid, ctx = _stage_points(
            cfg, s, *skips[-1], sizes[i + 1], part=part0 if i == 0 else None)
        pooled = _aggregate(params.stages[i], gfeats, gmask, cfg.variant)
        ctxs.append(ctx)
        skips.append((centers, pooled, svalid))

    if cfg.task == "cls":
        _, f, v = skips[-1]
        g = torch.where(v[..., None], f, -3.0e38).amax(1)
        return params.out(params.head(g))

    up = skips[-1][1]
    for i in range(len(cfg.fp_widths)):
        lvl = len(cfg.stages) - 1 - i
        merged = _propagate(cfg, ctxs[lvl], up, skips[lvl][1])
        up = params.fp[i](merged)
    return params.out(params.head(up))


# Paper Table I model presets -------------------------------------------------

def pointnet2_cls(n=1024, point_ops="global", th=64):
    return PNNConfig(name="pointnet2_cls", variant="pointnet2", task="cls",
                     n_points=n, point_ops=point_ops, th=th)


def pointnext_cls(n=1024, point_ops="global", th=64):
    return PNNConfig(name="pointnext_cls", variant="pointnext", task="cls",
                     n_points=n, point_ops=point_ops, th=th)


def pointnet2_seg(n=2048, point_ops="global", th=256):
    return PNNConfig(name="pointnet2_seg", variant="pointnet2", task="seg",
                     n_points=n, point_ops=point_ops, th=th)


def pointnext_seg(n=2048, point_ops="global", th=256):
    return PNNConfig(name="pointnext_seg", variant="pointnext", task="seg",
                     n_points=n, point_ops=point_ops, th=th)


def pointvector_seg(n=2048, point_ops="global", th=256):
    return PNNConfig(name="pointvector_seg", variant="pointvector",
                     task="seg", n_points=n, point_ops=point_ops, th=th)


def scene_seg(n=4096, th=256, widths=(32, 32, 64), fp=(64, 64), rate=0.25,
              radius=0.25, nsample=16):
    """Single-SA-stage segmentation config for scene tiling: every point op
    runs inside the stage-0 partition, the one ``apply(part0=...)`` takes."""
    return PNNConfig(name="scene_seg", variant="pointnet2", task="seg",
                     n_points=n, point_ops="bppo", th=th,
                     stages=(SAStage(rate, radius, nsample, widths),),
                     fp_widths=(fp,))
