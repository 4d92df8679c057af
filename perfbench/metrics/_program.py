"""Arithmetic the readers of the program's own telemetry share.

They read ``repro_torch.obs.snapshot()``, the port's registry of its
serving microbatches (spans with host ns and, on the card, CUDA-event ms
between consecutive span boundaries; the request records; the counters),
and find nothing where the program has no such registry.  The phase
classes are the benchmark's, from the span names alone: ``plan`` is the
stage-0 plan and each later stage's ``sa<i>.plan``; ``point_ops`` each
``*.sample``, ``*.group`` and ``*.interpolate``; ``mlp`` each ``*.mlp``
and ``head``.  A median or percentile runs over the microbatches (or
requests) the registry holds that ran with no profiler on: the profiler's
host cost would inflate the others.
"""
from __future__ import annotations

import numpy as np

CLASSES = {
    "plan": lambda n: n == "plan" or n.endswith(".plan"),
    "point_ops": lambda n: n.endswith((".sample", ".group", ".interpolate")),
    "mlp": lambda n: n == "head" or n.endswith(".mlp"),
    "microbatch": lambda n: n == "microbatch",
}


def snapshot():
    """The program's telemetry, or None where the program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def _records(snap) -> list:
    return [r for r in (snap or {}).get("microbatches") or ()
            if not r.get("profiled")]


def _percentile(values, q: float):
    return float(np.percentile(values, q)) if len(values) else None


def host_ms(snap, cls: str):
    """Median over the microbatches of the host ms of class ``cls``'s
    spans, summed in each."""
    match = CLASSES[cls]
    per = [sum(s["t1_ns"] - s["t0_ns"] for s in r["spans"]
               if match(s["name"])) / 1e6
           for r in _records(snap)
           if any(match(s["name"]) for s in r["spans"])]
    return _percentile(per, 50)


def device_ms(snap, cls: str):
    """Median over the microbatches read on the card of the device ms of
    class ``cls``'s spans, summed in each (from a span's start boundary to
    its end boundary)."""
    match = CLASSES[cls]
    per = []
    for r in _records(snap):
        dev = r.get("device_ms")
        spans = [s for s in r["spans"] if match(s["name"])]
        if dev is None or not spans:
            continue
        per.append(sum(sum(dev[s["b0"]:s["b1"]]) for s in spans))
    return _percentile(per, 50)


def engine_wait_ms(snap, q: float):
    """Percentile ``q`` of dispatch - submit, on the engine's clock, over
    the requests dispatched before the first one dispatched under a
    profiler: the queue a profiled stretch leaves behind inflates the
    waits after it."""
    reqs = [r for r in (snap or {}).get("requests") or ()
            if r["t_dispatch"] is not None and r["t_submit"] is not None]
    cut = min((r["t_dispatch"] for r in reqs if r.get("profiled")),
              default=None)
    return _percentile([(r["t_dispatch"] - r["t_submit"]) * 1e3
                        for r in reqs if cut is None or r["t_dispatch"] < cut],
                       q)


def pad_share(snap):
    """% of the microbatch slots dispatched that held padding."""
    c = (snap or {}).get("counters") or {}
    if not c.get("slots"):
        return None
    return 100.0 * c["padded_slots"] / c["slots"]


def gap_device_ms(snap):
    """Median device ms from a microbatch's copy_out end to the next one's
    copy_in start."""
    return _percentile([r["gap"]["device_ms"] for r in _records(snap)
                        if r.get("gap") and r["gap"]["device_ms"] is not None],
                       50)


def gap_program_share(snap):
    """Median % of the host interval between microbatches that the
    program's own spans (finish, admit, stack) cover."""
    return _percentile([100.0 * r["gap"]["program_ns"] / r["gap"]["host_ns"]
                        for r in _records(snap)
                        if r.get("gap") and r["gap"]["host_ns"] > 0], 50)


def leaf_fill(snap):
    """Median % of the stage-0 plan's leaf slots holding a valid point."""
    return _percentile([100.0 * r["leaf_fill"] for r in _records(snap)
                        if r.get("leaf_fill") is not None], 50)
