"""Zone config: which contract applies where in the port.

Counterpart of ``repro.analysis.zones``, over ``src/repro_torch``.  The
injected-clock discipline binds ``serve/`` and ``scene/``; the gradient
and dispatch contracts bind the kernel layer, and ``kernels/ops.py`` (the
public ops) most of all.  This module maps source paths to zone names and
zone names to the rule ids that run there, so a rule pass never needs path
logic of its own.

A file outside ``src/repro_torch`` (a test's source string, a fixture) can
pin its zone with a directive comment on any line::

    # repolint: zone=serve

A path under the JAX package (``src/repro/``) is ``other`` here.
"""
from __future__ import annotations

import re

from repro_torch.analysis.report import ERROR, WARN

PACKAGE = "repro_torch"
# Zone of the public ops: the dispatch layer carries contracts (gradient
# classification, device-only selection) that the kernel modules share in
# part.
KERNEL_OPS = "kernels.ops"
KERNEL_OPS_PATH = "src/repro_torch/kernels/ops.py"
# The one module outside the kernel layer that may name a device outright:
# it is the rule every entry point resolves its device by.
DEVICE_PATH = "src/repro_torch/device.py"
# Zone of the telemetry registry: the span clock (Unix ns, the profiler's)
# lives there, so the injected-clock zones never read it themselves.
OBS = "obs"
OBS_PATH = "src/repro_torch/obs.py"

ZONES = ("core", "kernels", KERNEL_OPS, "models", "serve", "scene", "train",
         "launch", "dist", "lm", "data", "configs", "analysis", OBS, "other")

_ALL = frozenset(ZONES)
_KERNELY = frozenset({"kernels", KERNEL_OPS})

# rule id -> zones where the pass runs.  PRG001 (unused pragma) is emitted
# by the walker itself and applies everywhere.
RULE_ZONES = {
    "CLK001": frozenset({"serve", "scene"}),
    "CLK002": _ALL,
    "CLK003": _ALL,
    "TRC001": _ALL,
    "VJP001": frozenset({KERNEL_OPS}),
    "DSP001": _KERNELY,
    "DSP002": _ALL - _KERNELY,
    "PRG001": _ALL,
}

# CLK003 is a warning: time.time() outside the clock-disciplined zones is a
# hazard (non-monotonic intervals), not a bug by itself.  --strict still
# fails on it.
RULE_SEVERITY = {rule: (WARN if rule == "CLK003" else ERROR)
                 for rule in RULE_ZONES}

RULE_DOC = {
    "CLK001": "wall-clock call in an injected-clock zone (serve/, scene/)",
    "CLK002": "wall-clock call inside a function taking a now= parameter",
    "CLK003": "time.time() or time.time_ns() wall clock (use time.monotonic "
              "or inject a clock)",
    "TRC001": "lru_cache over parameters that are not statically hashable",
    "VJP001": "public op not routed through kernels/vjp.py "
              "(IndexProducer | Gathering)",
    "DSP001": "dispatch by device only: no impl=, no environment, no "
              "fallback around a launch, wrappers branch on on_card",
    "DSP002": "hardcoded device= literal outside the kernel layer",
    "PRG001": "unused '# repolint: disable=' pragma",
    # Interface checks (emitted by abstract.py, not the AST lint).
    "ABS001": "output specs differ across the device x chunk matrix",
    "ABS002": "public op's specs disagree with its kernel's plain version",
    "ABS003": "launch geometry: threads not whole warps or above the "
              "function's limit, or grid beyond the device's",
    "ABS004": "launch footprint: shared memory above the opt-in limit, or "
              "registers spilled to local memory",
}

_ZONE_DIRECTIVE = re.compile(r"#\s*repolint:\s*zone=([a-z.]+)")


def zone_of(path: str, text: str = "") -> str:
    """Classify a source path (a directive comment wins over the path)."""
    m = _ZONE_DIRECTIVE.search(text)
    if m and m.group(1) in _ALL:
        return m.group(1)
    norm = str(path).replace("\\", "/")
    if norm.endswith(KERNEL_OPS_PATH):
        return KERNEL_OPS
    if norm.endswith(OBS_PATH):
        return OBS
    parts = norm.split("/")
    if PACKAGE in parts:
        i = len(parts) - 1 - parts[::-1].index(PACKAGE)  # last segment
        if i + 1 < len(parts) - 1 and parts[i + 1] in _ALL:
            return parts[i + 1]
    return "other"


def rules_for(zone: str):
    return frozenset(r for r, zs in RULE_ZONES.items() if zone in zs)
