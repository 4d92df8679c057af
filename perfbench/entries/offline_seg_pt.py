"""Offline segmentation through Point Transformer (``point_transformer``):
the closed loop of ``offline_seg_invres`` (whole rooms through the serving
engine, the queue kept one full microbatch ahead), loaded as a module of
its own with this configuration's hooks bound in place of PointNeXt-XL's:
the engine over the configuration's structure, the plain reference
``reference/point_transformer.py`` (through which the loop draws the
weights, BatchNorm's running statistics included, and computes the
logits it compares and the point ops' least time), and the FLOP count
``yardstick/flops_pt.py``.  The mix's parameters are ``offline_seg``'s.
"""
from __future__ import annotations

from pathlib import Path

from perfbench import harness
from perfbench.reference import point_transformer as reference
from perfbench.yardstick import flops_pt

loop = harness.load_file(Path(__file__).with_name("offline_seg_invres.py"),
                         "perfbench_entry_offline_seg_pt_loop")


def model_config(cfg: dict, n: int):
    """The configuration's network over ``n``-point clouds as a
    ``PNNConfig``, through the program's builder of the published
    numbers."""
    from repro_torch.models import point_transformer
    return point_transformer.config(
        planes=cfg["planes"], blocks=cfg["blocks"], nsample=cfg["nsample"],
        strides=cfg["strides"], share_planes=cfg["share_planes"],
        num_classes=cfg["num_classes"], n_points=n,
        in_channels=cfg["in_channels"], th=cfg["th"], name=cfg["name"])


def engine(ctx, weights: dict, *, bucket: int, microbatch: int,
           max_wait_s: float):
    """A ``ServeEngine`` over one bucket of the configuration's network,
    holding ``weights``, on the run's device."""
    import torch
    from repro_torch.models import pnn
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import MODEL_FIELDS
    mcfg = model_config(ctx.config, bucket)
    scfg = ServeConfig(
        buckets=(bucket,), microbatch=microbatch, max_wait_s=max_wait_s,
        variant=mcfg.variant, task=mcfg.task, num_classes=mcfg.num_classes,
        th=mcfg.th, on_overflow="silent",
        **{f: getattr(mcfg, f) for f in MODEL_FIELDS})
    model = pnn.init(mcfg, torch.Generator().manual_seed(0))
    model.load_state_dict({k: v.detach().cpu() for k, v in weights.items()},
                          strict=True)
    return ServeEngine(scfg, params=model.to(ctx.device), device=ctx.device)


loop.ref = reference
loop.flops_invres = flops_pt
loop.engine = engine
inputs, run, control = loop.inputs, loop.run, loop.control
