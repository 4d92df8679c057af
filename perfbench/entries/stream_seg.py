"""A stream of small clouds in an open loop: requests arrive on a schedule
drawn from the seed, whatever the server is doing, and each is timed from
when it was due.

The mix's parameters (``traffic/<mix>.json``): ``points`` a cloud (the one
bucket), each made by the copied room generator at ``extent`` and scaled by
``block_scale``; ``microbatch`` and ``max_wait_s`` of the engine's queue;
``rate_per_s``, the offered rate.  The window's requests are
``round(rate * seconds)``; their gaps are the exponential distribution's
quantiles at (k + 1/2) / count, in an order drawn from the seed, so every
seed offers the same gaps (a Poisson stream's) in another order.
``compare_requests`` of them, drawn from the seed, are held against the
reference; ``warm_batches`` microbatches of other clouds run in set-up.
With ``--trace 1`` a stream of ``trace_seconds`` more follows the window
under the profiler, for the device's numbers; the host's come from the
window, untraced.

A request still queued when the window closes is served after it and its
latency counts the wait.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import harness, serving
from perfbench.reference import pnn as ref
from perfbench.yardstick import scene
from perfbench.yardstick.trace import Tracer


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due offsets (s) of ``round(rate * seconds)`` requests."""
    count = max(1, int(round(rate * seconds)))
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / rate
    np.random.default_rng(harness.subseed(seed, 4)).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def make_clouds(ctx, count: int, stream: int) -> np.ndarray:
    tr = ctx.traffic
    pts, _ = scene.clouds(harness.subseed(ctx.seed, stream), count,
                          tr["points"], extent=tr["extent"],
                          device=ctx.device)
    return (pts * tr["block_scale"]).cpu().numpy()


def weights_of(ctx) -> dict:
    return harness.make_weights(ref.param_shapes(ctx.config),
                                harness.subseed(ctx.seed, 1), ctx.device)


def inputs(ctx, rate: float):
    """(due offsets, clouds, the requests compared), all from the seed."""
    due = arrivals(ctx.seed, rate, ctx.seconds)
    rng = np.random.default_rng(harness.subseed(ctx.seed, 3))
    keep = set(rng.choice(len(due), size=min(ctx.traffic["compare_requests"],
                                             len(due)),
                          replace=False).tolist())
    return due, make_clouds(ctx, len(due), 6), keep


def control(ctx) -> dict:
    """The control's readings on this seed's compared requests."""
    _, clouds, keep = inputs(ctx, ctx.traffic["rate_per_s"])
    return serving.control(ctx, weights_of(ctx), sorted(keep), clouds)


def build(ctx, weights):
    """The engine, warmed on ``warm_batches`` microbatches."""
    tr = ctx.traffic
    eng = serving.engine(ctx, weights, bucket=tr["points"],
                         microbatch=tr["microbatch"],
                         max_wait_s=tr["max_wait_s"])
    eng.warm()
    for c in make_clouds(ctx, tr["warm_batches"] * tr["microbatch"], 5):
        eng.submit(c)
    eng.flush()
    eng.results.clear()
    return eng


def stream(ctx, eng, clouds, due, tracer, keep=()) -> dict:
    """Offer ``clouds[i]`` at ``t0 + due[i]``; serve until every one is
    answered.  Returns the per-request latencies and queue waits, each
    serving step's time, the answers of ``keep``, the failures, and the
    window's start and length on the host clock."""
    n, classes = ctx.traffic["points"], ctx.config["num_classes"]
    count = len(due)
    lat = np.full(count, np.nan)
    wait = np.full(count, np.nan)
    service, kept = [], {}
    index = {}
    ctx.sync()
    tracer.start()
    t0 = ctx.clock()
    i = 0
    while True:
        now = ctx.clock()
        with tracer.span("submit"):
            while i < count and t0 + due[i] <= now:
                index[eng.submit(clouds[i], now=t0 + due[i])] = i
                i += 1
        t_in = ctx.clock()
        with tracer.span("step"):
            done = eng.step() if i < count else eng.flush()
        if done:
            t_out = ctx.clock()
            service.append(t_out - t_in)
            for rid in done:
                j = index.pop(rid)
                out = eng.take(rid)
                if serving.answer_ok(out, n, classes):
                    lat[j] = t_out - (t0 + due[j])
                    wait[j] = t_in - (t0 + due[j])
                    if j in keep:
                        kept[j] = [out]
            tracer.poll()
        if i == count:
            break          # flushed: whatever is left was lost
        if not done:
            nxt = t0 + due[i]
            if eng.queue.pending():
                nxt = min(nxt, t_in + eng.queue.max_wait_s / 4)
            time.sleep(max(0.0, min(nxt - ctx.clock(), 0.002)))
    tracer.stop()
    return {"latency_s": lat[~np.isnan(lat)], "wait_s": wait[~np.isnan(wait)],
            "service_s": np.asarray(service), "kept": kept,
            "failed": int(np.isnan(lat).sum()), "t0": t0,
            "window_s": ctx.clock() - t0}


def run(ctx) -> dict:
    tr = ctx.traffic
    weights = weights_of(ctx)
    eng = build(ctx, weights)
    due, clouds, keep = inputs(ctx, tr["rate_per_s"])
    s = stream(ctx, eng, clouds, due, Tracer(False, 0, ctx.sync), keep)
    peak = ctx.peak_bytes()
    record = {"chips": ctx.chips, "window_s": s["window_s"],
              "latency_s": s["latency_s"].tolist(),
              "service_s": s["service_s"].tolist(),
              "queue_wait_s": s["wait_s"].tolist()}
    if ctx.trace:
        # The device trace comes from a stream of its own after the
        # window, so the profiler's host cost cannot queue the window's
        # requests.
        tracer = Tracer(True, tr["trace_seconds"], ctx.sync)
        tracer.warm(lambda: eng.warm())
        t_due = arrivals(harness.subseed(ctx.seed, 8), tr["rate_per_s"],
                         tr["trace_seconds"])
        stream(ctx, eng, make_clouds(ctx, len(t_due), 9), t_due, tracer)
        record["trace"] = tracer.reduce()
    del eng
    ctx.free()
    readings = serving.compare(ctx, weights, s["kept"], clouds)
    readings["answers_failed"] = s["failed"]
    lat_ms = s["latency_s"] * 1e3
    return {"attempted": len(due), "failed": s["failed"],
            "end_to_end": {
                "setup_s": s["t0"] - ctx.t_start,
                "latency_p50_ms": float(np.percentile(lat_ms, 50))},
            "memory_peak_bytes": peak, "record": record,
            "readings": readings}
