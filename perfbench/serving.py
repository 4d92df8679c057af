"""The serving cells' shared parts: the program's engine built from a
configuration file and the benchmark's weights, and the comparison of
served logits with the plain reference.

The program is driven only through its public serving path:
``ServeEngine.submit / step / take`` over a ``ServeConfig`` that carries
the configuration's stages and FP widths, with the weights handed in as
a ``pnn.PNN`` whose tensors are the benchmark's.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference import pnn as ref
from perfbench.yardstick import work


def sa_stages(cfg: dict):
    from repro_torch.models import pnn
    return tuple(pnn.SAStage(s["rate"], s["radius"], s["nsample"],
                             tuple(s["widths"])) for s in cfg["stages"])


def program_model(cfg: dict, weights: dict, device, n_points: int = 1024):
    """(The program's ``pnn.PNN`` of ``cfg`` holding ``weights``, its
    ``PNNConfig`` for clouds of ``n_points``)."""
    import torch
    from repro_torch.models import pnn
    mcfg = pnn.PNNConfig(
        name=cfg["name"], variant=cfg["variant"], task="seg",
        num_classes=cfg["num_classes"], in_channels=cfg["in_channels"],
        stages=sa_stages(cfg),
        fp_widths=tuple(tuple(w) for w in cfg["fp_widths"]),
        head_widths=tuple(cfg["head_widths"]), point_ops="bppo",
        th=cfg["th"], n_points=n_points)
    model = pnn.PNN(mcfg, torch.Generator().manual_seed(0))
    model.load_state_dict({k: v.detach().cpu() for k, v in weights.items()},
                          strict=True)
    return model.to(device), mcfg


def engine(ctx, weights: dict, *, bucket: int, microbatch: int,
           max_wait_s: float):
    """A ``ServeEngine`` over one bucket, on the run's device."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ctx.config
    scfg = ServeConfig(
        buckets=(bucket,), microbatch=microbatch, max_wait_s=max_wait_s,
        variant=cfg["variant"], task="seg", num_classes=cfg["num_classes"],
        th=cfg["th"], stages=sa_stages(cfg),
        fp_widths=tuple(tuple(w) for w in cfg["fp_widths"]),
        on_overflow="silent")
    model, _ = program_model(cfg, weights, ctx.device, bucket)
    return ServeEngine(scfg, params=model, device=ctx.device)


def answer_ok(logits, n: int, classes: int) -> bool:
    """A served answer has one finite row of ``classes`` logits a point."""
    return (logits is not None and tuple(logits.shape) == (n, classes)
            and bool(np.isfinite(logits).all()))


def reference_logits(ctx, weights: dict, coords: np.ndarray, *,
                     tf32: bool = False, record=None) -> np.ndarray:
    """The plain reference's logits of one cloud, on the run's device."""
    import torch
    x = torch.as_tensor(coords, device=ctx.device)[None]
    out = ref.segment(ctx.config, weights, x, tf32=tf32,
                      chunk=ctx.traffic.get("reference_chunk", 1024),
                      record=record)
    return out[0].cpu().numpy()


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap between two clouds' logits, over the reference's
    largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.astype(np.float64) - want).max()) / scale


def compare(ctx, weights: dict, kept: dict, inputs) -> dict:
    """Readings of the served answers ``kept`` ({input index: [logits,
    ...]}) against the reference on ``inputs[index]``: ``logit_rel_err``,
    the widest over all of them."""
    worst = 0.0
    for i, answers in kept.items():
        want = reference_logits(ctx, weights, inputs[i])
        for got in answers:
            worst = max(worst, rel_err(got, want))
    return {"logit_rel_err": worst}


def control(ctx, weights: dict, indices, inputs) -> dict:
    """The control's reading: the reference computed in TF32, put in the
    program's place, on the same inputs, against the float32 reference."""
    worst = 0.0
    for i in indices:
        want = reference_logits(ctx, weights, inputs[i])
        got = reference_logits(ctx, weights, inputs[i], tf32=True)
        worst = max(worst, rel_err(got, want))
    return {"logit_rel_err": worst}


def point_ops_seconds(ctx, weights: dict, cloud) -> float:
    """The least time of one cloud's point ops on the card: each call of
    the reference plan (FPS, ball query, kNN, in-window gather) by
    ``yardstick/work.py``."""
    total = [0.0]

    def record(name, args):
        total[0] += work.least_seconds(name, args)

    reference_logits(ctx, weights, cloud, record=record)
    return total[0]
