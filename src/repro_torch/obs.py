"""Serving telemetry: spans and counters of the port's microbatches, held
in one process-wide registry.

The serving engine opens one record for each microbatch it runs
(``microbatch``), and the code under it marks its phases with ``span``::

    microbatch                        serve/engine.py: _execute
      stack, copy_in, plan, forward, copy_out, finish
        forward                       models/pnn.py: apply
          sa<i>.plan (i > 0), sa<i>.sample, sa<i>.group, sa<i>.mlp,
          fp<i>.interpolate, fp<i>.mlp, head

Phase classes (``PHASES``): ``plan`` is the stage-0 ``plan`` and every
later stage's ``sa<i>.plan``; ``point_ops`` every ``*.sample``,
``*.group`` and ``*.interpolate``; ``mlp`` every ``*.mlp`` and ``head``.

A span records its host start and end and its parent, the span that
encloses it.  On the card it also records a CUDA event, taken from a
pool, at each boundary it adds, on ``torch.cuda.current_stream(device)``.
A span's end shares the event of the next boundary (the next span's start,
or its parent's end): the code between them launches nothing, and so a
microbatch of n spans records about n events, not 2n.  The end of
``copy_out`` and of the microbatch record their own.  A record's device
intervals are read with ``Event.elapsed_time`` only
once its events have completed, which the next microbatch's logits copy
makes sure of; ``snapshot`` reads what has completed by then and waits for
nothing.  So the registry adds no synchronisation.  The one read-back is
the leaf fill (``leaf_fill``): one small sum after the microbatch's own
logits copy.  Outside an open microbatch (the trainer's ``pnn.apply``,
``ServeEngine.warm``) a span is a shared null context.  With
``enabled(False)`` nothing is recorded, and a span costs one module
attribute test: no clock read, no allocation, no event.

Each request gets a record too: its id, the microbatch that served it,
its submit and dispatch stamps on the engine's own clock (the engine's
``now``), and its ``admit`` span (the bucket padding in ``submit``) on
the span clock.  Request stamps and span stamps are never mixed.

The device gap of a microbatch runs from the previous microbatch's
``copy_out`` end to its own ``copy_in`` start, on the device's clock.
Over the same host interval the record keeps the host ns that the
program's own spans cover (``finish``, ``admit``, ``stack``, listed in
``GAP_SPANS``); the rest is the caller's.

A record made while torch's profiler ran says so (``profiled``): its host
times carry the profiler's own cost.

Counters, kept for each engine (``counters``) and summed in ``snapshot``:
``microbatches``, ``slots`` (microbatch slots dispatched) and
``padded_slots`` (those filled with an all-invalid cloud).  The rings keep
the last ``MICROBATCHES`` microbatches and ``REQUESTS`` requests.

Clock.  Span stamps are integer nanoseconds of Unix time, ``time.time_ns``
(CLOCK_REALTIME), the clock that torch's profiler stamps its host events
with (``c10::getTime``; the absolute ``KinetoEvent.start_ns()`` of
torch 2.11 and 2.13), so an operator can lay a span over a profiler trace
of the same process.  Unix time can step, so it is never read for a
decision: the queue's deadlines keep the engine's clock.  ``use_clock``
injects another one, for tests.

No profiler ranges.  The program opens no ``record_function`` and no NVTX
range: a profiler mirrors such a range onto the device's timeline, where
the mirror covers every idle gap inside the range, and a tool that counts
the device's intervals as busy time would then see an idle card as busy.
The spans stay here, and ``snapshot`` hands them to whoever lays them
over a trace.
"""
from __future__ import annotations

import collections
import itertools
import statistics
import time

import torch

MICROBATCHES = 4096
REQUESTS = 16384
PHASES = ("plan", "point_ops", "mlp")
GAP_SPANS = frozenset({"finish", "admit", "stack"})


def phase_of(name: str) -> str | None:
    """The phase class of a span name, or None outside every class."""
    if name == "plan" or name.endswith(".plan"):
        return "plan"
    if name.endswith((".sample", ".group", ".interpolate")):
        return "point_ops"
    if name == "head" or name.endswith(".mlp"):
        return "mlp"
    return None


class _Null:
    """The shared context of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_on = True
# The open microbatch's record; None when nothing records (off, or no
# microbatch open).  ``span`` tests this one attribute.
_active = None


class _Registry:
    """The rings, counters, event pool and gap bookkeeping."""

    def __init__(self, clock=time.time_ns):
        self.clock = clock
        self.microbatches = collections.deque(maxlen=MICROBATCHES)
        self.requests = collections.OrderedDict()   # (owner, rid) -> dict
        self.counters = {}         # owner -> {microbatches, slots, padded}
        self.pending = []          # records whose device ms are unread
        self.pool = []             # free CUDA events
        self.ids = itertools.count()
        self.owners = itertools.count()
        # The last copy_out end: (host ns, its event or None), and the
        # host ns of the program's spans since then.
        self.last_out = None
        self.between = 0

    @staticmethod
    def new_event():
        return torch.cuda.Event(enable_timing=True)

    def event(self, stream):
        ev = self.pool.pop() if self.pool else self.new_event()
        ev.record(stream)
        return ev

    def request(self, owner: int, rid: int) -> dict:
        key = (owner, rid)
        r = self.requests.get(key)
        if r is None:
            r = {"owner": owner, "rid": rid, "microbatch": None,
                 "t_submit": None, "t_dispatch": None, "admit_ns": None,
                 "profiled": False}
            self.requests[key] = r
            if len(self.requests) > REQUESTS:
                self.requests.popitem(last=False)
        return r

    def resolve(self):
        """Read the device ms of every pending record whose events have
        completed; return their events to the pool."""
        still = []
        for rec in self.pending:
            if rec.ready():
                self.pool.extend(rec.resolve())
            else:
                still.append(rec)
        self.pending = still


_reg = _Registry()


class _Microbatch:
    """One microbatch's record while it is open and until its device
    intervals are read."""

    def __init__(self, owner, bucket, requests, slots, t_dispatch, stream):
        self.id = next(_reg.ids)
        self.owner, self.bucket = owner, bucket
        self.rids = [r.rid for r in requests]
        self.slots, self.padded = slots, slots - len(requests)
        self.stream = stream
        self.spans = []            # [name, parent, t0, t1, b0, b1]
        self.stack = []
        self.waiting = []          # spans closed since the last boundary
        self.events = [] if stream is not None else None
        self.device_ms = None
        self.gap = None            # {"host_ns", "program_ns", "device_ms"}
        # The previous copy_out's end event and this copy_in's start
        # boundary; the copy_out end boundary a later gap reads.
        self.gap_from, self.gap_to, self.out = None, -1, -1
        self.leaf_fill = None
        self.profiled = torch.autograd._profiler_enabled()
        for r in requests:
            q = _reg.request(owner, r.rid)
            q["microbatch"], q["t_dispatch"] = self.id, t_dispatch
            q["t_submit"], q["profiled"] = r.t_submit, self.profiled

    def _boundary(self) -> int:
        """Record an event here (on the card); the spans closed since the
        last boundary end at it.  Returns its index, -1 off the card."""
        if self.events is None:
            return -1
        self.events.append(_reg.event(self.stream))
        b = len(self.events) - 1
        for k in self.waiting:
            self.spans[k][5] = b
        self.waiting.clear()
        return b

    def open(self, name: str) -> int:
        k = len(self.spans)
        b = self._boundary()
        t = _reg.clock()
        self.spans.append([name, self.stack[-1] if self.stack else -1,
                           t, 0, b, -1])
        self.stack.append(k)
        if name == "copy_in" and _reg.last_out is not None:
            t_out, ev = _reg.last_out
            self.gap = {"host_ns": t - t_out, "program_ns": _reg.between,
                        "device_ms": None}
            if ev is not None and b >= 0:
                self.gap_from, self.gap_to = ev, b
        return k

    def close(self, k: int, now: bool = False):
        """End span ``k``; its event is the next boundary's, or one of its
        own with ``now``."""
        s = self.spans[k]
        self.waiting.append(k)
        s[3] = t = _reg.clock()
        self.stack.pop()
        if s[0] in GAP_SPANS:
            _reg.between += t - s[2]
        elif s[0] == "copy_out":
            # The logits are on the host, so every event recorded before
            # this copy has completed.
            _reg.resolve()
            self.out = b = self._boundary()
            _reg.last_out = (t, None if b < 0 else self.events[b])
            _reg.between = 0
        if now and self.waiting:
            self._boundary()

    def ready(self) -> bool:
        last = [self.events[-1]] if self.events else []
        if self.gap_from is not None:
            last.append(self.gap_from)
        return all(ev.query() for ev in last)

    def resolve(self) -> list:
        """Read the device ms; returns the events now free (all but the
        copy_out end, which the next record's gap reads and frees)."""
        ev = self.events
        self.device_ms = [ev[i].elapsed_time(ev[i + 1])
                          for i in range(len(ev) - 1)]
        free = [e for i, e in enumerate(ev) if i != self.out]
        if self.gap_from is not None:
            self.gap["device_ms"] = self.gap_from.elapsed_time(
                ev[self.gap_to])
            free.append(self.gap_from)
        self.events = self.gap_from = None
        return free

    def data(self) -> dict:
        return {"id": self.id, "owner": self.owner, "bucket": self.bucket,
                "rids": list(self.rids), "slots": self.slots,
                "padded_slots": self.padded,
                "spans": [{"name": n, "parent": p, "t0_ns": t0, "t1_ns": t1,
                           "b0": b0, "b1": b1}
                          for n, p, t0, t1, b0, b1 in self.spans],
                "device_ms": (None if self.device_ms is None
                              else list(self.device_ms)),
                "gap": None if self.gap is None else dict(self.gap),
                "leaf_fill": self.leaf_fill, "profiled": self.profiled}


class _Span:
    __slots__ = ("mb", "name", "k")

    def __init__(self, mb, name):
        self.mb, self.name = mb, name

    def __enter__(self):
        self.k = self.mb.open(self.name)
        return self

    def __exit__(self, *exc):
        self.mb.close(self.k)
        return False


def span(name: str):
    """A span of the open microbatch, else the shared null context."""
    mb = _active
    if mb is None:
        return _NULL
    return _Span(mb, name)


class _Open:
    """The context of one microbatch: the record and its root span."""

    __slots__ = ("mb", "k")

    def __init__(self, mb):
        self.mb = mb

    def __enter__(self):
        global _active
        _active = self.mb
        self.k = self.mb.open("microbatch")
        return self

    def __exit__(self, exc_type, *exc):
        global _active
        _active = None
        if exc_type is not None:
            return False           # a failed microbatch leaves no record
        mb = self.mb
        mb.close(self.k, now=True)
        c = _reg.counters.setdefault(mb.owner, _zero_counters())
        c["microbatches"] += 1
        c["slots"] += mb.slots
        c["padded_slots"] += mb.padded
        _reg.microbatches.append(mb)
        if mb.events is not None:
            _reg.pending.append(mb)
        return False


def _zero_counters() -> dict:
    return {"microbatches": 0, "slots": 0, "padded_slots": 0}


def counters(owner: int | None = None) -> dict:
    """The counters of ``owner``'s microbatches, or of every engine's."""
    out = _zero_counters()
    for o, c in _reg.counters.items():
        if owner is None or o == owner:
            for k in out:
                out[k] += c[k]
    return out


def new_owner() -> int:
    """An id that tells one engine's records from another's."""
    return next(_reg.owners)


def microbatch(owner: int, bucket: int, requests, slots: int,
               t_dispatch: float, device):
    """Open the record of one microbatch of ``requests`` (objects with
    ``rid`` and ``t_submit``) in ``slots`` slots of ``bucket`` points,
    dispatched at ``t_dispatch`` on the engine's clock, run on
    ``device``; the root span ``microbatch``."""
    if not _on:
        return _NULL
    return _Open(_Microbatch(owner, bucket, requests, slots, t_dispatch,
                             _stream_of(device)))


def _stream_of(device):
    """The stream a record's events go on: the card's current one, or None
    off the card (no events)."""
    if getattr(device, "type", None) != "cuda":
        return None
    return torch.cuda.current_stream(device)


def stamp():
    """The span clock's now for a request's ``admit``, None when off."""
    return _reg.clock() if _on else None


def admitted(owner: int, rid: int, t_submit: float, t0) -> None:
    """Record request ``rid``'s admission: submitted at ``t_submit`` on
    the engine's clock, its ``admit`` span from ``t0`` (``stamp()``) to
    now."""
    if t0 is None or not _on:
        return
    t1 = _reg.clock()
    r = _reg.request(owner, rid)
    r["t_submit"], r["admit_ns"] = t_submit, [t0, t1]
    _reg.between += t1 - t0


def leaf_fill(vsize, th: int) -> None:
    """The open microbatch's share of stage-0 leaf slots ``vsize`` (B, ML)
    x ``th`` holding a valid point; reads one sum back to the host."""
    mb = _active
    if mb is None:
        return
    mb.leaf_fill = int(vsize.sum()) / (vsize.numel() * th)


def enabled(flag: bool | None = None) -> bool:
    """Turn recording on or off; returns whether it is on."""
    global _on
    if flag is not None:
        _on = bool(flag)
    return _on


def use_clock(clock=None):
    """Stamp spans with ``clock`` (integer ns), or ``time.time_ns`` when
    None; returns the clock it replaces."""
    old = _reg.clock
    _reg.clock = time.time_ns if clock is None else clock
    return old


def reset() -> None:
    """Clear every record, counter and pending event (the clock stays)."""
    global _reg
    _reg = _Registry(_reg.clock)


def snapshot() -> dict:
    """The registry as plain Python data: ``counters``, ``microbatches``
    (oldest first; see ``_Microbatch.data``) and ``requests``."""
    _reg.resolve()
    return {"enabled": _on, "counters": counters(),
            "microbatches": [mb.data() for mb in _reg.microbatches],
            "requests": [dict(r, admit_ns=None if r["admit_ns"] is None
                              else list(r["admit_ns"]))
                         for r in _reg.requests.values()]}


# -- reading a record -----------------------------------------------------

def span_ms(rec: dict, k: int) -> tuple:
    """(host ms, device ms or None) of span ``k`` of record ``rec``."""
    s = rec["spans"][k]
    host = (s["t1_ns"] - s["t0_ns"]) / 1e6
    dev = rec["device_ms"]
    if dev is None or s["b0"] < 0:
        return host, None
    return host, sum(dev[s["b0"]:s["b1"]])


def phases(rec: dict) -> dict:
    """{class: (host ms, device ms or None)} of one record: ``microbatch``
    and each of ``PHASES``, summed over the class's spans."""
    out = {"microbatch": span_ms(rec, 0)}
    for p in PHASES:
        ks = [k for k, s in enumerate(rec["spans"])
              if phase_of(s["name"]) == p]
        ms = [span_ms(rec, k) for k in ks]
        dev = [d for _, d in ms]
        out[p] = (sum(h for h, _ in ms),
                  None if None in dev else sum(dev))
    return out


def phase_medians(owner: int | None = None) -> dict:
    """{class: {"host_ms", "device_ms"}}: medians over the records held
    (of ``owner`` alone where given); device None off the card."""
    recs = [r for r in snapshot()["microbatches"]
            if owner is None or r["owner"] == owner]
    if not recs:
        return {}
    per = [phases(r) for r in recs]
    out = {}
    for p in ("microbatch",) + PHASES:
        host = [x[p][0] for x in per]
        dev = [x[p][1] for x in per if x[p][1] is not None]
        out[p] = {"host_ms": statistics.median(host),
                  "device_ms": statistics.median(dev) if dev else None}
    return out
