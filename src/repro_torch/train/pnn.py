"""PNN fine-tuning through the full BPPO pipeline, on one card or data
parallel over a mesh of cards.

Counterpart of ``repro.train.pnn``.  The gradient crosses every point op
through its rule in ``kernels/vjp.py``: the gather's backward is the
``scatter_add_blocks`` kernel on the card, and FPS, ball query and kNN pass
no gradient on.  The loop is ``train/loop.py`` (AdamW with clipping,
restore and resume, straggler monitor), the batches come from
``data/synthetic.py`` (a pure function of (seed, step), so a restart
reproduces the stream).

With ``mesh="auto"`` (``--mesh auto`` under torchrun, one process a card)
every rank initialises the parameters from the seed and takes rank 0's
once; each draws the whole batch and trains on its share of it
(``"batch"`` over the data axes, where the batch divides them), the leaf
blocks over ``"model"``; one all-reduce of one flat bucket over the data
group gives every rank the global-mean gradient and loss, before the
loop's error feedback, as the reference compresses the reduced gradient.

It runs on the card unless asked for the CPU::

  PYTHONPATH=src python -m repro_torch.train.pnn --preset pointnet2_seg \\
      --n 16384 --th 256 --batch 8 --steps 20
  PYTHONPATH=src python -m repro_torch.train.pnn --preset pointnet2_seg \\
      --n 256 --th 64 --batch 2 --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.train.pnn --preset pointnet2_seg \\
      --n 256 --th 64 --batch 2 --steps 3 --compression int8 --device cpu
  python -m torch.distributed.run --nproc-per-node 4 -m \
      repro_torch.train.pnn --preset pointnet2_seg --n 16384 --th 256 \
      --batch 8 --steps 20 --mesh auto
"""
from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.dist import elastic, logical, process
from repro_torch.models import pnn
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib

PRESETS = {
    "pointnet2_cls": pnn.pointnet2_cls,
    "pointnext_cls": pnn.pointnext_cls,
    "pointnet2_seg": pnn.pointnet2_seg,
    "pointnext_seg": pnn.pointnext_seg,
    "pointvector_seg": pnn.pointvector_seg,
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Fine-tune knobs: model preset + data shape + loop + device."""

    preset: str = "pointnet2_cls"
    n_points: int = 192
    th: int = 32
    point_ops: str = "bppo"          # bppo | global
    batch: int = 8
    steps: int = 20
    lr: float = 3e-3
    weight_decay: float = 0.0
    seed: int = 0
    mesh: str = "none"               # none | auto (the process world's mesh)
    model_axis: int = 2
    leaf_chunk: int | None = None
    ckpt_dir: str = ""
    ckpt_every: int = 50
    grad_compression: str = "none"   # none | bf16 | int8
    device: str | None = None        # None: the card; "cpu": plain versions


def model_config(cfg: TrainConfig) -> pnn.PNNConfig:
    mcfg = PRESETS[cfg.preset](n=cfg.n_points, point_ops=cfg.point_ops,
                               th=cfg.th)
    return dataclasses.replace(mcfg, leaf_chunk=cfg.leaf_chunk)


def param_dict(model: pnn.PNN) -> dict:
    """{JAX tree path ("stages/0/mlp/0/dense/w"): parameter} of ``model``;
    the tensors are the module's own."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def loss_fn(model: pnn.PNN, mcfg: pnn.PNNConfig, batch: dict):
    """Masked cross-entropy over a batch dict {points, labels[, valid]}.

    Returns (loss, {"acc": ...}), both scalar tensors on the batch's
    device."""
    pts, labels = batch["points"], batch["labels"]
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device)
    logits = pnn.apply(model, mcfg, pts, valid=valid)
    ll = torch.log_softmax(logits, -1)
    if mcfg.task == "cls":
        loss = -torch.gather(ll, -1, labels[:, None].long()).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
    else:
        picked = torch.gather(ll, -1, labels[..., None].long())[..., 0]
        denom = valid.sum().clamp(min=1)
        loss = -torch.where(valid, picked, 0.0).sum() / denom
        acc = ((logits.argmax(-1) == labels) & valid).sum() / denom
    return loss, {"acc": acc}


def grads_fn(model: pnn.PNN, mcfg: pnn.PNNConfig):
    """``grads(params, batch) -> (grads {name: tensor}, metrics)`` for the
    parameters ``params`` (``param_dict(model)``); a parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives."""
    def grads(params, batch):
        loss, aux = loss_fn(model, mcfg, batch)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        out = {k: torch.zeros_like(p) if g is None else g
               for (k, p), g in zip(params.items(), gs)}
        return out, {"loss": loss.detach(), **{k: v.detach()
                                               for k, v in aux.items()}}
    return grads


def mean_over_batch(grads: dict, metrics: dict, batch: int):
    """The gradient and the metrics of the global-mean loss, from this
    rank's share of a ``batch`` of clouds (inside the mesh's rules).

    Every cloud weighs alike (the trainer's clouds have no padding), so
    the global mean is the mean of the shards' means: one all-reduce of
    one flat bucket over the group the batch was split over, divided by
    its size.  Where the batch stayed whole (``logical.placement``) every
    rank holds the full gradient already, and a sum would multiply it by
    the group's size.  Then the ranks that computed the same gradient
    (the batch's other mesh axes, or the whole world where it stayed
    whole) take the first one's bits, so the parameters stay identical
    even where the card's atomics added in another order."""
    ctx = logical.current()
    if ctx is None:
        return grads, metrics
    mesh = ctx.mesh
    names = [k for k, v in metrics.items() if v.dim() == 0]
    flat = torch.cat([g.reshape(-1) for g in grads.values()]
                     + [metrics[k].reshape(1).to(torch.float32)
                        for k in names])
    split = logical.placement("batch", batch)
    if split is not None:
        group, ways, _ = split
        dist.all_reduce(flat, group=group)
        flat = flat / ways
        spec = logical.spec(("batch",))[0]
        axes = (spec,) if isinstance(spec, str) else spec
        copies = mesh.group(a for a in mesh.axis_names if a not in axes)
    else:
        copies = mesh.group(mesh.axis_names)
    if copies is not None:
        group, _ = copies
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    out, offset = {}, 0
    for k, g in grads.items():
        out[k] = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    metrics = dict(metrics)
    for i, k in enumerate(names):
        metrics[k] = flat[offset + i].to(metrics[k].dtype)
    return out, metrics


def make_train_step(model: pnn.PNN, mcfg: pnn.PNNConfig,
                    opt_cfg: opt_lib.OptConfig, reduce=None):
    """One AdamW step on ``model``'s parameters (in place):
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``return_grads=True`` hands the grads back instead, ``(grads,
    metrics)``, for the loop's gradient-compression / error-feedback
    path.  ``reduce(grads, metrics) -> (grads, metrics)`` (a mesh's
    ``mean_over_batch``) runs first on both paths."""
    grads = grads_fn(model, mcfg)

    def step(params, opt_state, batch, return_grads=False):
        g, metrics = grads(params, batch)
        if reduce is not None:
            g, metrics = reduce(g, metrics)
        if return_grads:
            return g, metrics
        params, opt_state, om = opt_lib.update(opt_cfg, g, opt_state, params)
        return params, opt_state, {**metrics, **om}

    return step


def fit(cfg: TrainConfig, params: pnn.PNN | None = None, log=print,
        mesh=None):
    """Run the fine-tune loop; returns (model, opt_state, info).

    ``params`` optionally supplies the model (e.g. ``convert.from_jax``);
    it is moved to the device and trained in place.  ``info["history"]``
    holds {step, dt, loss, straggler} per step (the loss the global
    mean).  With ``ckpt_dir`` set the loop restores the latest step and
    resumes.  ``mesh`` (else ``cfg.mesh="auto"``: the process world's
    elastic mesh) trains data parallel, each rank on its own device."""
    if cfg.mesh not in ("none", "auto"):
        raise ValueError(f"mesh must be 'none' or 'auto', got {cfg.mesh!r}")
    if mesh is None and cfg.mesh == "auto":
        mesh = elastic.make_mesh(model_axis=cfg.model_axis, device=cfg.device)
    device = resolve_device(cfg.device) if mesh is None else mesh.device
    mcfg = model_config(cfg)
    model = params if params is not None else pnn.init(
        mcfg, torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    if mesh is not None:
        log(f"[train.pnn] mesh {mesh.shape} ({mesh.world.size} ranks, "
            f"{mesh.world.backend}), rank {mesh.world.rank} on "
            f"{mesh.device}")
        process.broadcast_(mesh.world, model.parameters())

    def next_batch(step):
        make = (synthetic.classification_batch if mcfg.task == "cls"
                else synthetic.segmentation_batch)
        pts, labels = make(cfg.seed + 11, step, cfg.batch, cfg.n_points,
                           device=device)
        with logical.mesh_rules(mesh):
            return {"points": logical.shard(pts, 0, "batch"),
                    "labels": logical.shard(labels, 0, "batch")}

    opt_cfg = opt_lib.OptConfig(lr=cfg.lr, warmup=0,
                                total_steps=max(cfg.steps, 1),
                                weight_decay=cfg.weight_decay)
    base = make_train_step(
        model, mcfg, opt_cfg,
        reduce=None if mesh is None else
        lambda g, m: mean_over_batch(g, m, cfg.batch))

    def train_step(*args, **kw):
        with logical.mesh_rules(mesh):
            return base(*args, **kw)

    loop_cfg = loop_lib.LoopConfig(
        total_steps=cfg.steps, ckpt_dir=cfg.ckpt_dir,
        ckpt_every=cfg.ckpt_every, log_every=max(1, cfg.steps // 5),
        grad_compression=cfg.grad_compression, seed=cfg.seed)
    _, opt_state, info = loop_lib.run(
        loop_cfg, init_params=lambda: param_dict(model),
        train_step=train_step, next_batch=next_batch, opt_cfg=opt_cfg,
        log=log, world=None if mesh is None else mesh.world)
    return model, opt_state, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="pointnet2_cls",
                    choices=sorted(PRESETS))
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--th", type=int, default=32)
    ap.add_argument("--point-ops", default="bppo", choices=["bppo", "global"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none", choices=["none", "auto"],
                    help="auto: data parallel over the process world's "
                         "mesh (run under torchrun, one process a card)")
    ap.add_argument("--leaf-chunk", type=int, default=None)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)

    cfg = TrainConfig(preset=args.preset, n_points=args.n, th=args.th,
                      point_ops=args.point_ops, batch=args.batch,
                      steps=args.steps, lr=args.lr, seed=args.seed,
                      mesh=args.mesh, leaf_chunk=args.leaf_chunk,
                      ckpt_dir=args.ckpt, grad_compression=args.compression,
                      device=args.device)
    mesh = (elastic.make_mesh(model_axis=cfg.model_axis, device=cfg.device)
            if cfg.mesh == "auto" else None)
    world = None if mesh is None else mesh.world
    _, _, info = fit(cfg, log=process.log_of(world), mesh=mesh)
    if world is not None and world.rank != 0:
        return 0
    h = info["history"]
    if h:
        print(f"[train.pnn] done: loss {h[0]['loss']:.4f} -> "
              f"{h[-1]['loss']:.4f} over {len(h)} steps; "
              f"{info['monitor']}")
    else:
        print("[train.pnn] nothing to do: checkpoint already at "
              f"step >= {args.steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
