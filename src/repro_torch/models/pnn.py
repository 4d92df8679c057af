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
ops on either device, as the JAX package computes it.  Every tensor this
module holds is in the clouds' own point order.  BPPO's ops work in the
partition's sorted frame (``core/bppo.py``): their neighbour indices are
composed with ``part.perm`` into indices of the cloud before anything is
gathered, and their per-point rows (the InvResMLP search, the FP stage's
interpolated features) go back through ``fractal.unpermute``.

Variants: ``pointnet2`` (group -> shared MLP -> max-pool), ``pointnext``
(+ inverted-residual MLP blocks after pooling), ``pointvector`` (learned
per-neighbour gating before pooling), and ``pointnext_invres``, PointNeXt's
published encoder (Qian et al., NeurIPS 2022): each SA stage followed by
``blocks[i]`` InvResMLP blocks on the stage's own points.  A block groups
every point's neighbours within ``radius_scaling`` (PointNeXt's 2) times
the stage's radius, runs a dense layer over each neighbour's offset and
features and a max-pool (local aggregation), then a pointwise C ->
``expansion`` * C -> C pair, adds its input and applies a ReLU.  The blocks
of a stage search the same points at the same radius, so their neighbours
are found once a stage.  With ``point_ops="bppo"`` that search is block
parallel at stride 1 (``bppo.blockwise_ball_query_points``) over the
level's partition, which the next SA stage reuses.  The local
aggregation's layer is linear before its ReLU, so its feature half runs
once a point and ``kernels.ops.local_aggregate`` adds each neighbour's
offset term, applies the ReLU and pools, with no grouped tensor built
(the blocks need ``norm="batchnorm"``).  ``point_transformer`` (Point
Transformer, ``models/point_transformer.py``) has a forward of its own:
``init`` and ``apply`` hand it over, and ``stem_k``, ``enc_blocks`` and
``share_planes`` are its fields.  Options the
published net needs, off by default: ``stem_width`` (a dense layer on the input features before
stage 0; its output is level 0's skip), ``normalize_dp`` (grouped offsets
divided by the search radius) and ``norm="batchnorm"`` (BatchNorm in
inference form, folded into each layer's dense weights).

Inside a serving microbatch ``apply`` marks its phases as
``repro_torch.obs`` spans: ``stem.mlp``, ``sa<i>.plan`` (a later stage's
partition), ``sa<i>.sample``, ``sa<i>.group``, ``sa<i>.mlp``, for the
InvResMLP blocks ``sa<i>.res.plan`` (the last stage's partition, which no
SA stage follows), ``sa<i>.res.group`` (the stage's one search) and
``sa<i>.res<j>.mlp`` (block j's local aggregation and layers),
``fp<i>.interpolate``, ``fp<i>.mlp`` and ``head``; and counts the
``res_queries`` and ``res_blocks`` it runs (``obs.tally``).  Elsewhere
they record nothing.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch import obs
from repro_torch.core import bppo, ref
from repro_torch.core.fractal import partition, take, unpermute
from repro_torch.kernels import ops


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
                                     # | pointnext_invres | point_transformer
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
    # pointnext_invres; the defaults leave the other variants as they are
    blocks: tuple = ()               # InvResMLP blocks after each SA stage
    expansion: int = 4               # a block's pointwise width over C
    stem_width: int = 0              # dense stem before stage 0 (0: none)
    normalize_dp: bool = False       # grouped offsets over the radius
    norm: str = "layernorm"          # layernorm | batchnorm (inference)
    radius_scaling: float = 2.0      # a block's search radius over its SA's
    # point_transformer (models/point_transformer.py); the defaults leave
    # the other variants as they are
    stem_k: int = 0                  # kNN neighbours at level 0 (levels
                                     # 1+ take their stage's nsample)
    enc_blocks: tuple = ()           # encoder blocks at each level
    share_planes: int = 8            # channel groups sharing a weight

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


class BatchNorm(nn.Module):
    """BatchNorm in inference form: ``(x - mean) / sqrt(var + eps) * g +
    b`` per channel, from the running statistics ``mean`` and ``var``."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        self.b = nn.Parameter(torch.zeros(d))
        self.register_buffer("mean", torch.zeros(d))
        self.register_buffer("var", torch.ones(d))
        self.eps = eps

    def affine(self):
        """(scale, shift): the norm as ``x * scale + shift``."""
        scale = self.g * torch.rsqrt(self.var + self.eps)
        return scale, self.b - self.mean * scale


class Layer(nn.Module):
    """Dense, norm, ReLU.  BatchNorm is folded into the dense weights and
    bias, so the layer is one matmul with its bias."""

    def __init__(self, din: int, dout: int, generator: torch.Generator,
                 norm: str = "layernorm"):
        super().__init__()
        self.dense = Dense(din, dout, generator)
        self.norm = norm
        if norm == "batchnorm":
            self.bn = BatchNorm(dout)
        elif norm == "layernorm":
            self.ln = LayerNorm(dout)
        else:
            raise ValueError(f"norm must be 'layernorm' or 'batchnorm', "
                             f"got {norm!r}")

    def folded(self):
        """(w, b): the dense weights and bias with BatchNorm folded in."""
        scale, shift = self.bn.affine()
        return self.dense.w * scale, self.dense.b * scale + shift

    def forward(self, x, act: bool = True):
        if self.norm == "layernorm":
            x = self.ln(self.dense(x))
        else:
            w, b = self.folded()
            x = torch.addmm(b, x.reshape(-1, x.shape[-1]), w).view(
                *x.shape[:-1], w.shape[1])
        return torch.relu(x) if act else x


class MLP(nn.ModuleList):
    """A list of (dense, norm) layers, each followed by ReLU."""

    def __init__(self, din: int, widths, generator: torch.Generator,
                 norm: str = "layernorm"):
        layers = []
        for w in widths:
            layers.append(Layer(din, w, generator, norm))
            din = w
        super().__init__(layers)

    def forward(self, x):
        for layer in self:
            x = layer(x)
        return x


class InvResMLP(nn.Module):
    """PointNeXt's inverted-residual block on C channels: local
    aggregation (``la``: a dense layer over each neighbour's offset and
    features, ``cat([rel, f_j])``, max-pooled), then ``pw1`` (C ->
    expansion * C, ReLU) and ``pw2`` (back to C, no ReLU), the block's
    input added, and a ReLU.  ``la``'s BatchNorm is folded into its weights
    W and bias b as ``Layer`` folds it; then W [rel ; f_j] + b = rel . W[:3]
    + (f @ W[3:])[j] + b, so the feature half runs once a point and
    ``ops.local_aggregate`` does the rest without a grouped tensor."""

    def __init__(self, c: int, expansion: int, norm: str,
                 generator: torch.Generator):
        super().__init__()
        if norm != "batchnorm":
            raise ValueError(f"InvResMLP blocks need norm 'batchnorm' (their "
                             f"local aggregation splits the folded layer), "
                             f"got {norm!r}")
        self.la = Layer(c + 3, c, generator, norm)
        self.pw1 = Layer(c, c * expansion, generator, norm)
        self.pw2 = Layer(c * expansion, c, generator, norm)

    def forward(self, f, nidx, gmask, rel):
        """f (B, m, C); nidx (B, m, ns) int32, each centre's neighbour rows
        of f; gmask (B, m, ns); rel (B, m, ns, 3) their offsets."""
        w, b = self.la.folded()
        g = ops.local_aggregate(f @ w[3:], nidx, gmask, rel, w[:3], b)
        return torch.relu(f + self.pw2(self.pw1(g), act=False))


class Stage(nn.Module):
    def __init__(self, cfg: PNNConfig, c_in: int, s: SAStage,
                 generator: torch.Generator, blocks: int = 0):
        super().__init__()
        self.mlp = MLP(c_in + 3, s.widths, generator, cfg.norm)
        if cfg.variant == "pointvector":
            self.vec = Dense(c_in + 3, s.widths[-1], generator)
        if cfg.variant == "pointnext":
            self.res = nn.ModuleList(
                MLP(s.widths[-1], (2 * s.widths[-1], s.widths[-1]), generator)
                for _ in range(cfg.num_blocks))
        if cfg.variant == "pointnext_invres":
            self.blocks = nn.ModuleList(
                InvResMLP(s.widths[-1], cfg.expansion, cfg.norm, generator)
                for _ in range(blocks))


class PNN(nn.Module):
    def __init__(self, cfg: PNNConfig, generator: torch.Generator):
        super().__init__()
        blocks = cfg.blocks or (0,) * len(cfg.stages)
        if len(blocks) != len(cfg.stages):
            raise ValueError(f"blocks {cfg.blocks} does not give one count "
                             f"a stage ({len(cfg.stages)} stages)")
        if any(blocks) and cfg.variant != "pointnext_invres":
            raise ValueError(f"InvResMLP blocks need variant "
                             f"'pointnext_invres', got {cfg.variant!r}")
        c0 = cfg.in_channels
        if cfg.stem_width:
            self.stem = Dense(cfg.in_channels, cfg.stem_width, generator)
            c0 = cfg.stem_width
        stages, c_in = [], c0
        for s, k in zip(cfg.stages, blocks):
            stages.append(Stage(cfg, c_in, s, generator, k))
            c_in = s.widths[-1]
        self.stages = nn.ModuleList(stages)
        fp = []
        if cfg.task == "seg":
            skip_dims = [c0] + [s.widths[-1] for s in cfg.stages[:-1]]
            up_dim = cfg.stages[-1].widths[-1]
            for i, widths in enumerate(cfg.fp_widths):
                fp.append(MLP(up_dim + skip_dims[-(i + 1)], widths, generator,
                              cfg.norm))
                up_dim = widths[-1]
            head_in = up_dim
        else:
            head_in = cfg.stages[-1].widths[-1]
        self.fp = nn.ModuleList(fp)
        self.head = MLP(head_in, cfg.head_widths, generator, cfg.norm)
        self.out = Dense(cfg.head_widths[-1], cfg.num_classes, generator)


def init(cfg: PNNConfig, generator: torch.Generator | None = None,
         device: str | torch.device = "cpu") -> PNN:
    """Random weights from ``generator`` (a CPU ``torch.Generator``; seed 0
    when None), moved to ``device``.  torch and jax.random draw different
    numbers from one seed: parity tests carry JAX weights over with
    ``repro_torch.convert`` instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if cfg.variant == "point_transformer":
        from repro_torch.models import point_transformer
        return point_transformer.PointTransformer(cfg, generator).to(device)
    return PNN(cfg, generator).to(device)


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sa_names(i: int) -> tuple:
    """(plan, sample, group, mlp) span names of SA stage ``i``, made once."""
    return tuple(f"sa{i}.{k}" for k in ("plan", "sample", "group", "mlp"))


@functools.lru_cache(maxsize=None)
def _res_names(i: int, blocks: int, last: bool) -> tuple:
    """(plan, search, (each block's span)) names of SA stage ``i``'s
    InvResMLP blocks, made once: the level's partition is the next stage's
    ``sa<i+1>.plan``, or ``sa<i>.res.plan`` after the last stage."""
    plan = f"sa{i}.res.plan" if last else f"sa{i + 1}.plan"
    return plan, f"sa{i}.res.group", tuple(
        f"sa{i}.res{j}.mlp" for j in range(blocks))


@functools.lru_cache(maxsize=None)
def fp_names(i: int) -> tuple:
    """(interpolate, mlp) span names of FP stage ``i``, made once."""
    return (f"fp{i}.interpolate", f"fp{i}.mlp")


def _stage_points(cfg: PNNConfig, stage: SAStage, coords, feats, valid,
                  n_out, *, names, part=None):
    """One sampling + grouping + gathering round over B clouds.  Returns
    (centers (B, n_out, 3), grouped (B, n_out, nsample, C+3), gmask,
    new_valid, ctx); ``names`` are the stage's span names (``sa_names``);
    ``part`` optionally supplies a precomputed partition of (coords,
    valid) -- the serving plan (bppo only).  Every tensor is in the
    clouds' own order: BPPO's neighbour indices into its sorted frame are
    composed with ``part.perm`` before anything is gathered."""
    plan_span, sample_span, group_span, _ = names
    global_ops = cfg.point_ops == "global"
    if global_ops:
        with obs.span(sample_span):
            sidx, svalid = ref.fps(coords, valid, n_out)
            centers = take(coords, sidx)
        ctx = {"mode": "global", "coords": coords, "centers": centers,
               "svalid": svalid}
    else:
        if part is None:
            with obs.span(plan_span):
                part = partition(coords, valid, th=cfg.th,
                                 strategy=cfg.strategy, on_overflow="silent")
        with obs.span(sample_span):
            samp = bppo.blockwise_fps(part, rate=stage.rate, k_out=n_out,
                                      bs=cfg.th)
        centers, svalid = samp.coords, samp.valid
        ctx = {"mode": "bppo", "part": part, "samp": samp}
    with obs.span(group_span):
        if global_ops:
            nidx, cnt = ref.ball_query(coords, valid, centers, svalid,
                                       stage.radius, stage.nsample)
            slot = torch.arange(stage.nsample, device=coords.device)
            mask = (slot < cnt.clamp(max=stage.nsample)[..., None]) \
                & svalid[..., None]
        else:
            nb = bppo.blockwise_ball_query(part, samp, radius=stage.radius,
                                           num=stage.nsample, w=2 * cfg.th,
                                           chunk=cfg.leaf_chunk)
            nidx, mask = take(part.perm, nb.idx), nb.mask
        gmask = torch.cat([svalid[..., None], mask[..., 1:]], -1)
        rel = _offsets(cfg, take(coords, nidx), centers, stage.radius)
        gfeats = torch.cat([rel, take(feats, nidx)], -1)
    return centers, gfeats, gmask, svalid, ctx


def _propagate(cfg: PNNConfig, ctx, coarse_feats, fine_feats):
    """FP stage: interpolate coarse feats onto the fine cloud (3-NN IDW),
    the result in the fine cloud's own order beside its skip features."""
    if ctx["mode"] == "global":
        out, _, _ = ref.interpolate_3nn(ctx["coords"], ctx["centers"],
                                        ctx["svalid"], coarse_feats)
    else:
        part = ctx["part"]
        wc = max(16, int(2 * cfg.th * cfg.stages[0].rate))
        out = unpermute(part, bppo.blockwise_interpolate(
            part, ctx["samp"], coarse_feats, wc=wc, bs=cfg.th,
            chunk=cfg.leaf_chunk))
    return torch.cat([out, fine_feats], -1)


def _offsets(cfg: PNNConfig, neighbors, centers, radius: float):
    """Grouped offsets (B, m, ns, 3) of neighbours from their centres,
    over ``radius`` with ``normalize_dp``."""
    rel = neighbors - centers[:, :, None, :]
    return rel / radius if cfg.normalize_dp else rel


def _pool(h, gmask):
    """Max over the valid neighbours (B, m, ns, C) -> (B, m, C); 0 where a
    centre has none."""
    h = torch.where(gmask[..., None], h, -3.0e38)
    pooled = h.amax(-2)
    return torch.where(gmask.any(-1, keepdim=True), pooled, 0.0)


def _aggregate(stage_p: Stage, gfeats, gmask, variant):
    h = stage_p.mlp(gfeats)                                # (B, m, ns, C')
    if variant == "pointvector":
        h = h * torch.sigmoid(stage_p.vec(gfeats))
    pooled = _pool(h, gmask)
    if variant == "pointnext":
        for blk in stage_p.res:
            pooled = pooled + blk(pooled)
    return pooled


def _res_blocks(cfg: PNNConfig, i: int, stage_p: Stage, coords, f, valid):
    """SA stage ``i``'s InvResMLP blocks on its own points: coords
    (B, m, 3), features f (B, m, C), valid (B, m).  One neighbour search
    for all of them (the same points at the same radius give every block
    the same neighbours), mapped once to the clouds' order as int32 rows
    with their offsets, so no block permutes or gathers features itself;
    then the block's layers a block.  Returns (f, the level's partition
    for the next SA stage, None for the global ops)."""
    s = cfg.stages[i]
    radius = s.radius * cfg.radius_scaling
    plan_span, search_span, block_spans = _res_names(
        i, len(stage_p.blocks), i == len(cfg.stages) - 1)
    part = None
    if cfg.point_ops == "bppo":
        with obs.span(plan_span):
            part = partition(coords, valid, th=cfg.th,
                             strategy=cfg.strategy, on_overflow="silent")
    with obs.span(search_span):
        if part is None:
            nidx, cnt = ref.ball_query(coords, valid, coords, valid, radius,
                                       s.nsample)
            slot = torch.arange(s.nsample, device=coords.device)
            gmask = (slot < cnt.clamp(max=s.nsample)[..., None]) \
                & valid[..., None]
        else:
            nidx, gmask = bppo.blockwise_ball_query_points(
                part, radius=radius, num=s.nsample, w=2 * cfg.th, bs=cfg.th,
                chunk=cfg.leaf_chunk)
            # a centre's nearest in-radius neighbour is itself: every
            # searched point has slot 0 valid, and a point never searched
            # (invalid, or past th in an overflowing leaf) has none
            nidx = unpermute(part, take(part.perm, nidx))
            gmask = unpermute(part, gmask)
        rel = _offsets(cfg, take(coords, nidx), coords, radius)
        nidx = nidx.to(torch.int32)
    obs.tally("res_queries")
    for blk, span in zip(stage_p.blocks, block_spans):
        with obs.span(span):
            f = blk(f, nidx, gmask, rel)
        obs.tally("res_blocks")
    return f, part


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
    if cfg.variant == "point_transformer":
        from repro_torch.models import point_transformer
        return point_transformer.apply(params, cfg, coords, feats, valid,
                                       part0)
    if cfg.stem_width:
        with obs.span("stem.mlp"):
            feats = params.stem(feats)
    sizes = cfg.stage_sizes()
    skips = [(coords, feats, valid)]
    ctxs = []
    part = part0
    for i, s in enumerate(cfg.stages):
        names = sa_names(i)
        centers, gfeats, gmask, svalid, ctx = _stage_points(
            cfg, s, *skips[-1], sizes[i + 1], names=names, part=part)
        with obs.span(names[3]):
            pooled = _aggregate(params.stages[i], gfeats, gmask, cfg.variant)
        part = None
        if cfg.variant == "pointnext_invres" and len(params.stages[i].blocks):
            pooled, part = _res_blocks(cfg, i, params.stages[i], centers,
                                       pooled, svalid)
        ctxs.append(ctx)
        skips.append((centers, pooled, svalid))

    if cfg.task == "cls":
        with obs.span("head"):
            _, f, v = skips[-1]
            g = torch.where(v[..., None], f, -3.0e38).amax(1)
            return params.out(params.head(g))

    up = skips[-1][1]
    for i in range(len(cfg.fp_widths)):
        lvl = len(cfg.stages) - 1 - i
        interpolate_span, mlp_span = fp_names(i)
        with obs.span(interpolate_span):
            merged = _propagate(cfg, ctxs[lvl], up, skips[lvl][1])
        with obs.span(mlp_span):
            up = params.fp[i](merged)
    with obs.span("head"):
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


def pointnext_xl_seg(n=289_000, point_ops="global", th=256, in_channels=3):
    """PointNeXt-XL for S3DIS segmentation (``cfgs/s3dis/pointnext-xl.yaml``
    of the PointNeXt repository): stem width 64, blocks [1, 4, 7, 4, 4] at
    strides [1, 4, 4, 4, 4] (a stem, then four stride-4 SA stages of one
    layer, ``sa_layers`` 1, followed by 3, 6, 3 and 3 InvResMLP blocks),
    expansion 4, radius 0.1 doubling a stage with the blocks at twice
    their stage's, 32 neighbours, ``normalize_dp``, BatchNorm; the decoder
    back to 64 and a 64-wide head over 13 classes.  The published net
    takes 4 input channels (RGB and height); ``in_channels`` 3 takes the
    coordinates."""
    return PNNConfig(
        name="pointnext_xl_seg", variant="pointnext_invres", task="seg",
        num_classes=13, n_points=n, in_channels=in_channels,
        stages=(SAStage(0.25, 0.1, 32, (128,)), SAStage(0.25, 0.2, 32, (256,)),
                SAStage(0.25, 0.4, 32, (512,)),
                SAStage(0.25, 0.8, 32, (1024,))),
        blocks=(3, 6, 3, 3), expansion=4, stem_width=64,
        normalize_dp=True, norm="batchnorm", radius_scaling=2.0,
        fp_widths=((512, 512), (256, 256), (128, 128), (64, 64)),
        head_widths=(64,), point_ops=point_ops, th=th)


def point_transformer_seg(n=289_000, point_ops="bppo", th=256,
                          in_channels=3):
    """Point Transformer for S3DIS segmentation (Zhao et al., ICCV 2021;
    ``pointtransformer_seg_repro`` of the authors' repository): planes
    [32, 64, 128, 256, 512] at strides [1, 4, 4, 4, 4], blocks [2, 3, 4,
    6, 3], kNN of [8, 16, 16, 16, 16], share_planes 8, 13 classes, built by
    ``point_transformer.config``.  The published net takes 6 input
    channels (xyz and RGB); ``in_channels`` 3 takes the coordinates."""
    from repro_torch.models import point_transformer
    return point_transformer.config(
        planes=(32, 64, 128, 256, 512), blocks=(2, 3, 4, 6, 3),
        nsample=(8, 16, 16, 16, 16), strides=(1, 4, 4, 4, 4),
        share_planes=8, num_classes=13, n_points=n, in_channels=in_channels,
        point_ops=point_ops, th=th, name="point_transformer_seg")
