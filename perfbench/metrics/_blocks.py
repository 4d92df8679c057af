"""The program's InvResMLP spans, read as ``_program`` reads the others:
the stage's one search ``sa<i>.res.group`` and each block's gather
``sa<i>.res<j>.group`` (the blocks' point ops), and each block's layers
``sa<i>.res<j>.mlp``.  A median over the microbatches read on the card
that ran with no profiler on; nothing where the program has no such
spans."""
from __future__ import annotations

import re

from perfbench.metrics import _program

POINT_OPS = re.compile(r"sa\d+\.res\d*\.group")
MLP = re.compile(r"sa\d+\.res\d+\.mlp")


def device_ms(pattern):
    """Median device ms a microbatch of the spans whose whole name
    matches ``pattern``, summed in each."""
    per = []
    for r in _program._records(_program.snapshot()):
        dev = r.get("device_ms")
        spans = [s for s in r["spans"] if pattern.fullmatch(s["name"])]
        if dev is None or not spans:
            continue
        per.append(sum(sum(dev[s["b0"]:s["b1"]]) for s in spans))
    return _program._percentile(per, 50)
