"""Offline segmentation through PointNeXt with InvResMLP blocks
(``pointnext_invres``, PointNeXt-XL): ``offline_seg``'s closed loop of
whole rooms through the serving engine, the queue kept one full
microbatch ahead, held against ``reference/pointnext.py``.

The mix's parameters (``traffic/<mix>.json``) are ``offline_seg``'s:
``points`` a room (the one bucket), ``microbatch``, ``pool`` distinct rooms
made in set-up with the copied room generator at ``extent`` from
``room_seed``; the seed draws the order they are sent in (cycled), the
weights, and the ``compare_rooms`` of them whose every answer in the
window is held against the reference (in chunks of ``reference_chunk``
leaves).  ``trace_seconds`` of the window are traced with ``--trace 1``.
The window is a whole number of microbatches, as there.

The engine is the program's ``ServeEngine`` over a ``ServeConfig`` that
carries the configuration's structure (stages, blocks, stem, norm, ...)
and the benchmark's weights; BatchNorm's running statistics are drawn
from the seed too (``make_weights``).
"""
from __future__ import annotations

import numpy as np

from perfbench import harness, serving
from perfbench.reference import pointnext as ref
from perfbench.yardstick import flops_invres, scene, work
from perfbench.yardstick.trace import Tracer

# ServeConfig's and PNNConfig's structural fields, from the configuration.
STRUCTURE = ("blocks", "expansion", "stem_width", "normalize_dp", "norm",
             "radius_scaling")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``harness.make_weights`` of the reference's shapes, with BatchNorm's
    running variance positive: ``var = exp(0.2 * normal)`` (its draw is
    ``0.1 * normal``); the running mean is that draw, ``0.1 * normal``."""
    import torch
    w = harness.make_weights(ref.param_shapes(cfg), seed, device)
    for k in w:
        if k.endswith(".var"):
            w[k] = torch.exp(2.0 * w[k])
    return w


def structure(cfg: dict) -> dict:
    """The model's structure as ``ServeConfig`` / ``PNNConfig`` fields."""
    out = {k: cfg[k] for k in STRUCTURE}
    out["blocks"] = tuple(cfg["blocks"])
    out.update(stages=serving.sa_stages(cfg),
               fp_widths=tuple(tuple(w) for w in cfg["fp_widths"]),
               head_widths=tuple(cfg["head_widths"]))
    return out


def engine(ctx, weights: dict, *, bucket: int, microbatch: int,
           max_wait_s: float):
    """A ``ServeEngine`` over one bucket of the configuration's network,
    holding ``weights``, on the run's device."""
    import torch
    from repro_torch.models import pnn
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ctx.config
    scfg = ServeConfig(
        buckets=(bucket,), microbatch=microbatch, max_wait_s=max_wait_s,
        variant=cfg["variant"], task="seg", num_classes=cfg["num_classes"],
        th=cfg["th"], on_overflow="silent", **structure(cfg))
    mcfg = pnn.PNNConfig(
        name=cfg["name"], variant=cfg["variant"], task="seg",
        num_classes=cfg["num_classes"], in_channels=cfg["in_channels"],
        point_ops="bppo", th=cfg["th"], n_points=bucket, **structure(cfg))
    model = pnn.PNN(mcfg, torch.Generator().manual_seed(0))
    model.load_state_dict({k: v.detach().cpu() for k, v in weights.items()},
                          strict=True)
    return ServeEngine(scfg, params=model.to(ctx.device), device=ctx.device)


def make_rooms(ctx) -> list:
    tr = ctx.traffic
    pts, _ = scene.clouds(tr["room_seed"], tr["pool"], tr["points"],
                          extent=tr["extent"], device=ctx.device)
    return list(pts.cpu().numpy())


def inputs(ctx):
    """(weights, rooms, the order they are sent in, the rooms compared)."""
    tr = ctx.traffic
    weights = make_weights(ctx.config, harness.subseed(ctx.seed, 1),
                           ctx.device)
    rng = np.random.default_rng(harness.subseed(ctx.seed, 3))
    order = rng.permutation(tr["pool"]).tolist()
    sampled = set(rng.choice(tr["pool"], size=min(tr["compare_rooms"],
                                                  tr["pool"]),
                             replace=False).tolist())
    return weights, make_rooms(ctx), order, sampled


def reference_logits(ctx, weights: dict, coords: np.ndarray, *,
                     tf32: bool = False, record=None) -> np.ndarray:
    """The plain reference's logits of one cloud, on the run's device."""
    import torch
    x = torch.as_tensor(coords, device=ctx.device)[None]
    out = ref.segment(ctx.config, weights, x, tf32=tf32,
                      chunk=ctx.traffic.get("reference_chunk", 1024),
                      record=record)
    return out[0].cpu().numpy()


def compare(ctx, weights: dict, kept: dict, rooms) -> dict:
    """``logit_rel_err``: the widest of ``serving.rel_err`` over every kept
    answer ({room: [logits, ...]}) against the reference on its room."""
    worst = 0.0
    for i, answers in kept.items():
        want = reference_logits(ctx, weights, rooms[i])
        for got in answers:
            worst = max(worst, serving.rel_err(got, want))
    return {"logit_rel_err": worst}


def control(ctx) -> dict:
    """The control's readings on this seed's compared rooms: the reference
    computed in TF32, in the program's place, against the float32 one."""
    weights, rooms, _, sampled = inputs(ctx)
    worst = 0.0
    for i in sorted(sampled):
        want = reference_logits(ctx, weights, rooms[i])
        got = reference_logits(ctx, weights, rooms[i], tf32=True)
        worst = max(worst, serving.rel_err(got, want))
    return {"logit_rel_err": worst}


def point_ops_seconds(ctx, weights: dict, cloud) -> float:
    """The least time of one cloud's point ops on the card: each call of
    the reference plan that ``record`` sees (FPS, ball query, one stride-1
    search a stage, kNN, in-window gather) by ``yardstick/work.py``."""
    total = [0.0]

    def record(name, args):
        total[0] += work.least_seconds(name, args)

    reference_logits(ctx, weights, cloud, record=record)
    return total[0]


def run(ctx) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    n, mb, pool = tr["points"], tr["microbatch"], tr["pool"]
    weights, rooms, order, sampled = inputs(ctx)
    eng = engine(ctx, weights, bucket=n, microbatch=mb,
                 max_wait_s=tr["max_wait_s"])
    eng.warm()
    for j in range(mb):
        eng.submit(rooms[j % pool])
    eng.step()
    eng.results.clear()

    tracer = Tracer(ctx.trace, tr["trace_seconds"], ctx.sync)
    tracer.warm(lambda: eng.warm())
    ctx.sync()
    tracer.start()
    t0 = ctx.clock()
    setup_s = t0 - ctx.t_start
    k, points, attempted, failed = 0, 0, 0, 0
    kept, traced_rooms = {}, []
    while True:
        with tracer.span("submit"):
            rids = {}
            for j in range(k, k + mb):
                room = order[j % pool]
                rids[eng.submit(rooms[room])] = room
        with tracer.span("step"):
            done = eng.step()
        t_done = ctx.clock()
        if tracer.active:
            traced_rooms += list(rids.values())
        tracer.poll()
        attempted += len(rids)
        k += mb
        for rid, room in rids.items():
            out = eng.take(rid) if rid in done else None
            if not serving.answer_ok(out, n, cfg["num_classes"]):
                failed += 1
                continue
            points += n
            if room in sampled:
                kept.setdefault(room, []).append(out)
        if t_done - t0 >= ctx.seconds:
            break
    tracer.stop()
    window_s = t_done - t0
    peak = ctx.peak_bytes()
    trace = tracer.reduce()
    del eng
    ctx.free()

    readings = compare(ctx, weights, kept, rooms)
    readings["answers_failed"] = failed
    record = {"chips": ctx.chips, "window_s": window_s, "trace": trace}
    if trace is not None:
        record["flops_done"] = (points / n
                                * flops_invres.seg_forward_flops(cfg, n))
        least = {r: point_ops_seconds(ctx, weights, rooms[r])
                 for r in set(traced_rooms)}
        record["point_ops_least_s"] = sum(least[r] for r in traced_rooms)
    return {"attempted": attempted, "failed": failed,
            "end_to_end": {"setup_s": setup_s,
                           "seg_points_per_s": points / window_s},
            "memory_peak_bytes": peak, "record": record,
            "readings": readings}
