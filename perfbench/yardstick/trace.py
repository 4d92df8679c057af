"""Reading the device trace of a window: a frozen copy of the arithmetic
of the program's ``chip_smoke.report_profile`` (device busy from
``torch.profiler``, idle = 1 - busy / wall) and ``launch/mesh_smoke
.profile_step`` (collective device time by name), extended to the
timeline: busy is the union of the intervals in which an operation ran
on the device, and the idle gaps are named by the harness's own host
annotation (``bench.*``) under which they fell.

``Tracer`` holds the profiler over the first ``seconds`` of a window.
"""
from __future__ import annotations

import time

ANNOTATION = "bench."
# Host annotations the profiler mirrors onto the device's timeline: the
# harness's own spans and torch.distributed's ("nccl:all_reduce").
MIRRORED = (ANNOTATION, "nccl:")
COLLECTIVES = ("AllReduce", "AllGather", "Broadcast", "ReduceScatter")


class Tracer:
    """``start()`` at the window's start, ``poll()`` after each unit of
    work (stops once ``seconds`` have passed), ``stop()`` at the latest at
    the window's end.  Does nothing when ``enabled`` is false."""

    def __init__(self, enabled: bool, seconds: float, sync):
        self.enabled, self.seconds, self.sync = enabled, seconds, sync
        self.prof = None
        self.window_s = None
        self._t0 = None
        self._annot = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self, work):
        """Run ``work()`` once under a throw-away profiler, so that the
        tracer's own first start (CUPTI's set-up, seconds) falls in
        set-up and not in the window."""
        if not self.enabled:
            return
        with self._profile():
            work()
            self.sync()

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import record_function
        self.prof = self._profile()
        self.prof.__enter__()
        self._annot = record_function(ANNOTATION + "window")
        self._annot.__enter__()
        self._t0 = time.monotonic()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.window_s is None

    def poll(self):
        if self.active and time.monotonic() - self._t0 >= self.seconds:
            self.stop()

    def stop(self):
        if not self.active:
            return
        self.sync()
        self.window_s = time.monotonic() - self._t0
        self._annot.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def span(self, name: str):
        """A host annotation ``bench.<name>`` while tracing, else nothing."""
        import contextlib
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(ANNOTATION + name)

    def reduce(self, top: int = 10) -> dict | None:
        """The trace's numbers (see ``reduce``), or None untraced."""
        if self.prof is None:
            return None
        return reduce(self.prof, self.window_s, top)


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def _is_device(e) -> bool:
    """A device operation: not the device-side mirror of a host
    annotation, which the profiler also files under the device."""
    return _on_device(e) and not e.key.startswith(MIRRORED)


def _device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def reduce(prof, window_s: float, top: int = 10) -> dict:
    """From a finished profiler: ``busy_s`` (union of device intervals
    inside the ``bench.window`` annotation), ``window_s``, ``kernels``
    ({name: [device seconds, count]}), ``collective_s`` (device seconds of
    NCCL collectives), and the breakdown's ``device_ops`` and ``idle_gaps``
    ([name, seconds], longest first, ``top`` of each)."""
    events = list(prof.events())
    spans = [e for e in events if not _on_device(e)
             and e.name.startswith(ANNOTATION)]
    win = [e for e in spans if e.name == ANNOTATION + "window"]
    lo = min(e.time_range.start for e in win) if win else None
    hi = max(e.time_range.end for e in win) if win else None
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if _is_device(e)
                  and e.time_range.end > e.time_range.start), key=lambda t: t[0])
    if lo is None and dev:
        lo, hi = dev[0][0], dev[-1][1]
    kernels = {}
    for e in prof.key_averages():
        if _is_device(e) and _device_us(e) > 0:
            k = kernels.setdefault(e.key, [0.0, 0])
            k[0] += _device_us(e) / 1e6
            k[1] += e.count
    busy_us, gaps, at = 0.0, [], lo
    for s, t, name in dev:
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if s > at:
            gaps.append((s - at, at, name))
        busy_us += max(0.0, t - max(s, at))
        at = max(at, t)
    if hi is not None and hi > at:
        gaps.append((hi - at, at, "(end of window)"))
    gaps.sort(reverse=True)
    named = []
    for length, start, nxt in gaps[:top]:
        host = [e for e in spans if e.name != ANNOTATION + "window"
                and e.time_range.start <= start < e.time_range.end]
        where = (min(host, key=lambda e: e.time_range.end
                     - e.time_range.start).name if host else "host")
        named.append([f"{where} before {nxt[:80]}", length / 1e6])
    ops = sorted(([k, v[0]] for k, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    coll = sum(v[0] for k, v in kernels.items()
               if any(c.lower() in k.lower() for c in COLLECTIVES))
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": kernels, "collective_s": coll,
            "device_ops": [[k[:120], s] for k, s in ops],
            "idle_gaps": named}
