"""Step-time monitoring + straggler detection.

The port's own copy of ``repro.train.monitor`` (the port imports nothing
of the JAX package).  At 1000+ nodes, slow steps are usually one slow
host.  The monitor keeps an EWMA/variance of step times and flags
outliers (z-score) — the launcher's hook point for straggler mitigation
(re-dispatch, drop-host, or alert).
A ``HeartbeatFile`` gives the external supervisor a liveness signal; on a
real cluster this is the per-host file a watchdog scrapes.
"""
from __future__ import annotations

import json
import os
import time


class StepMonitor:
    def __init__(self, alpha: float = 0.1, z_thresh: float = 4.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.z = z_thresh
        self.warmup = warmup
        self.mean = None
        self.var = 0.0
        self.count = 0
        self.stragglers = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.count > self.warmup:
            sd = max(self.var ** 0.5, 1e-6, 0.05 * self.mean)
            if (dt - self.mean) / sd > self.z:
                is_straggler = True
                self.stragglers.append((step, dt, self.mean))
        # EWMA update (skip straggler samples so they don't poison the mean)
        if not is_straggler:
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler

    def summary(self):
        return {"mean_s": self.mean, "std_s": self.var ** 0.5,
                "steps": self.count, "stragglers": len(self.stragglers)}


class HeartbeatFile:
    """Liveness file for an external watchdog.  The stamped time must be
    *wall* clock (the watchdog is a different process, so a monotonic
    reading would be meaningless to it) — but it enters through an
    injectable ``clock`` so tests and replayed traces stay deterministic,
    the same discipline ServeEngine uses."""

    def __init__(self, path: str, every: float = 10.0, clock=time.time):
        self.path = path
        self.every = every
        self._clock = clock
        self._last = 0.0

    def beat(self, step: int, payload=None):
        now = self._clock()
        if now - self._last < self.every:
            return
        self._last = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": now,
                       "payload": payload or {}}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, timeout: float = 60.0,
                 clock=time.time) -> bool:
        try:
            with open(path) as f:
                data = json.load(f)
            return clock() - data["time"] < timeout
        except (OSError, ValueError, KeyError):
            return False
