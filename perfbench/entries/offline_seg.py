"""Offline segmentation in a closed loop: whole rooms through the serving
engine, the queue kept one full microbatch ahead.

The mix's parameters (``traffic/<mix>.json``): ``points`` a room (the one
bucket), ``microbatch``, ``pool`` distinct rooms made in set-up with the
copied room generator at ``extent`` from ``room_seed`` and held on the
host as users send them.  Every seed sends the same rooms, so every run
does the same work: the seed draws the order they are sent in (cycled),
the weights, and the ``compare_rooms`` of them whose every answer in the
window is held against the reference.  ``trace_seconds`` of the window are
traced with ``--trace 1``.

The window is a whole number of microbatches: it starts with the first
``submit`` and ends when the first microbatch that completes at least
``--seconds`` after the start has its logits on the host, so every point
counted was segmented inside it.
"""
from __future__ import annotations

import numpy as np

from perfbench import harness, serving
from perfbench.reference import pnn as ref
from perfbench.yardstick import flops, scene
from perfbench.yardstick.trace import Tracer


def make_rooms(ctx) -> list:
    tr = ctx.traffic
    pts, _ = scene.clouds(tr["room_seed"], tr["pool"], tr["points"],
                          extent=tr["extent"], device=ctx.device)
    return list(pts.cpu().numpy())


def inputs(ctx):
    """(weights, rooms, the order they are sent in, the rooms compared)."""
    tr = ctx.traffic
    weights = harness.make_weights(ref.param_shapes(ctx.config),
                                   harness.subseed(ctx.seed, 1), ctx.device)
    rng = np.random.default_rng(harness.subseed(ctx.seed, 3))
    order = rng.permutation(tr["pool"]).tolist()
    sampled = set(rng.choice(tr["pool"], size=min(tr["compare_rooms"],
                                                  tr["pool"]),
                             replace=False).tolist())
    return weights, make_rooms(ctx), order, sampled


def control(ctx) -> dict:
    """The control's readings on this seed's compared rooms."""
    weights, rooms, _, sampled = inputs(ctx)
    return serving.control(ctx, weights, sorted(sampled), rooms)


def run(ctx) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    n, mb, pool = tr["points"], tr["microbatch"], tr["pool"]
    weights, rooms, order, sampled = inputs(ctx)
    eng = serving.engine(ctx, weights, bucket=n, microbatch=mb,
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

    readings = serving.compare(ctx, weights, kept, rooms)
    readings["answers_failed"] = failed
    record = {"chips": ctx.chips, "window_s": window_s, "trace": trace}
    if trace is not None:
        record["flops_done"] = (points / n * flops.seg_forward_flops(cfg, n))
        least = {r: serving.point_ops_seconds(ctx, weights, rooms[r])
                 for r in set(traced_rooms)}
        record["point_ops_least_s"] = sum(least[r] for r in traced_rooms)
    return {"attempted": attempted, "failed": failed,
            "end_to_end": {"setup_s": setup_s,
                           "seg_points_per_s": points / window_s},
            "memory_peak_bytes": peak, "record": record,
            "readings": readings}
