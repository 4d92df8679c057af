"""Arithmetic the per-layer readers share."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from perfbench.yardstick.peaks import PEAK_FLOPS_FP32


def idle_share(record: dict):
    """% of the traced window in which no operation ran on the device."""
    t = record.get("trace")
    if not t or not t["window_s"] or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_seconds(record: dict, ops) -> float | None:
    """Device seconds of the kernels named for ``ops`` in
    ``point_ops_kernels.json`` (a kernel's name holds one of the op's
    substrings), or None where none ran."""
    t = record.get("trace")
    if not t:
        return None
    names = json.loads((Path(__file__).parent / "point_ops_kernels.json")
                       .read_text())
    subs = [s for op in ops for s in names[op]]
    secs = sum(v[0] for k, v in t["kernels"].items()
               if any(s in k for s in subs))
    return secs if secs > 0 else None


def roofline(record: dict, ops, least_key: str):
    """% of the least time of the point ops over their device time."""
    secs = kernel_seconds(record, ops)
    least = record.get(least_key)
    if secs is None or not least:
        return None
    return 100.0 * least / secs


def mfu(record: dict):
    """% of the float32 peak: matmul FLOPs done / (window x peak x chips)."""
    f = record.get("flops_done")
    if not f or not record.get("window_s"):
        return None
    return 100.0 * f / (record["window_s"] * PEAK_FLOPS_FP32 * record["chips"])


def percentile_ms(values, q: float):
    if values is None or len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values) * 1e3, q))
