"""The port's serving telemetry (``repro_torch.obs``) on the CPU: what the
serving engine and the PNN forward record, that recording changes no
logit, that it costs nothing when off, and that its clock is the
profiler's.

The device half (CUDA events) is driven here with stand-in events on a
stand-in stream, which stamp the span clock; the card runs the real ones.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs, serve  # noqa: E402
from repro_torch.analysis import walker, zones  # noqa: E402
from repro_torch.models import pnn  # noqa: E402

STAGES = (pnn.SAStage(0.25, 0.4, 8, (16,)),
          pnn.SAStage(0.25, 0.8, 8, (16, 32)))
FP = ((16, 16), (16,))
SA_KINDS = ("sample", "group", "mlp")


@pytest.fixture(autouse=True)
def _fresh_registry():
    """Each test starts from an empty, enabled registry on the real clock,
    with one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    obs.enabled(True)
    old = obs.use_clock(None)
    yield
    obs.use_clock(old)
    obs.enabled(True)
    obs.reset()
    torch.set_num_threads(n)


class FakeClock:
    """The engine's clock: seconds, set by the test."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class CountingClock:
    """A span clock (ns) that counts its reads."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return 1_000 * self.calls


def engine(point_ops="bppo", microbatch=2, max_wait_s=0.0, clock=None):
    cfg = serve.ServeConfig(buckets=(256,), microbatch=microbatch,
                            max_wait_s=max_wait_s, variant="pointnet2",
                            task="seg", th=32, point_ops=point_ops,
                            stages=STAGES, fp_widths=FP)
    kw = {} if clock is None else {"clock": clock}
    return serve.ServeEngine(cfg, seed=1, device="cpu", **kw)


def clouds(k, n=200, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(k)]


def serve_all(eng, cs):
    rids = [eng.submit(c) for c in cs]
    eng.step()
    eng.flush()
    return [eng.take(r) for r in rids]


def test_logits_bit_identical_on_and_off():
    cs = clouds(3)
    got = {}
    for flag in (True, False):
        obs.enabled(flag)
        got[flag] = serve_all(engine(), cs)
    for a, b in zip(got[True], got[False]):
        assert a.shape == (200, 6)
        np.testing.assert_array_equal(a, b)
    assert obs.snapshot()["counters"]["microbatches"] == 2   # on only


@pytest.mark.parametrize("point_ops", ["bppo", "global"])
def test_every_stage_spans_nest_once_a_microbatch(point_ops):
    serve_all(engine(point_ops), clouds(3))
    recs = obs.snapshot()["microbatches"]
    assert len(recs) == 2
    want = {"microbatch", "stack", "copy_in", "forward", "copy_out",
            "finish", "head"}
    want |= {f"sa{i}.{k}" for i in range(len(STAGES)) for k in SA_KINDS}
    want |= {f"fp{i}.{k}" for i in range(len(FP))
             for k in ("interpolate", "mlp")}
    if point_ops == "bppo":
        want |= {"plan"} | {f"sa{i}.plan" for i in range(1, len(STAGES))}
    for rec in recs:
        assert rec["profiled"] is False
        names = [s["name"] for s in rec["spans"]]
        assert sorted(names) == sorted(want)           # each exactly once
        spans = rec["spans"]
        assert spans[0]["name"] == "microbatch" and spans[0]["parent"] == -1
        for k, s in enumerate(spans):
            assert s["t0_ns"] <= s["t1_ns"]
            if k:
                p = spans[s["parent"]]
                assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
            kids = sum(c["t1_ns"] - c["t0_ns"] for c in spans
                       if c["parent"] == k)
            assert s["t1_ns"] - s["t0_ns"] - kids >= 0   # self time
        forward = names.index("forward")
        for s in spans:
            if obs.phase_of(s["name"]) and s["name"] != "plan":
                assert s["parent"] == forward
        if point_ops == "bppo":
            assert 0 < rec["leaf_fill"] < 1
        else:
            assert rec["leaf_fill"] is None
    ph = obs.phases(recs[0])
    assert set(ph) == {"microbatch", "plan", "point_ops", "mlp", "attn"}
    assert ph["attn"][0] == 0                  # no attention in this net
    assert sum(ph[p][0] for p in obs.PHASES) <= ph["microbatch"][0]


def test_deadline_flushed_partial_has_exact_wait_and_padding():
    clock = FakeClock(10.0)
    eng = engine(microbatch=4, max_wait_s=0.25, clock=clock)
    rid = eng.submit(clouds(1)[0])
    clock.t = 10.125
    assert eng.step() == []                      # partial, not yet due
    clock.t = 10.375
    assert eng.step() == [rid]                   # deadline flush
    snap = obs.snapshot()
    assert snap["counters"] == {"microbatches": 1, "slots": 4,
                                "padded_slots": 3}
    (req,) = snap["requests"]
    (rec,) = snap["microbatches"]
    assert (req["rid"], req["microbatch"]) == (rid, rec["id"])
    assert req["t_submit"] == 10.0 and req["t_dispatch"] == 10.375
    assert req["t_dispatch"] - req["t_submit"] == 0.375
    assert (rec["slots"], rec["padded_slots"], rec["rids"]) == (4, 3, [rid])
    st = eng.stats()
    assert st["padding"] == snap["counters"]
    assert st["phases"]["microbatch"]["host_ms"] > 0
    other = engine()
    serve_all(other, clouds(2))                  # one full microbatch
    assert other.stats()["padding"] == {"microbatches": 1, "slots": 2,
                                        "padded_slots": 0}
    assert eng.stats()["padding"] == st["padding"]
    assert obs.snapshot()["counters"]["slots"] == 6


def test_off_reads_no_clock_and_records_nothing():
    clock = CountingClock()
    obs.use_clock(clock)
    obs.enabled(False)
    assert obs.span("sa0.sample") is obs.span("head")   # the shared null
    serve_all(engine(), clouds(2))
    assert clock.calls == 0
    snap = obs.snapshot()
    assert snap["microbatches"] == [] and snap["requests"] == []
    assert snap["counters"]["microbatches"] == 0
    obs.enabled(True)
    serve_all(engine(), clouds(2))
    assert clock.calls > 0


def test_nothing_recorded_outside_an_open_microbatch():
    clock = CountingClock()
    obs.use_clock(clock)
    eng = engine()
    eng.warm()
    cfg = eng._model_cfg(256)
    with torch.inference_mode():
        pnn.apply(eng.params, cfg, torch.zeros((1, 256, 3)))
    assert clock.calls == 0
    snap = obs.snapshot()
    assert snap["microbatches"] == [] and snap["requests"] == []


def test_rings_stay_at_their_bounds(monkeypatch):
    monkeypatch.setattr(obs, "MICROBATCHES", 3)
    monkeypatch.setattr(obs, "REQUESTS", 5)
    obs.reset()
    cpu = torch.device("cpu")
    for i in range(8):
        reqs = [types.SimpleNamespace(rid=2 * i + j, t_submit=float(i))
                for j in range(2)]
        for r in reqs:
            obs.admitted(0, r.rid, r.t_submit, obs.stamp())
        with obs.microbatch(0, 64, reqs, 2, float(i), cpu):
            with obs.span("forward"):
                pass
    snap = obs.snapshot()
    assert [r["id"] for r in snap["microbatches"]] == [5, 6, 7]
    assert [r["rid"] for r in snap["requests"]] == [11, 12, 13, 14, 15]
    assert snap["counters"]["microbatches"] == 8     # counters do not roll


def test_span_clock_is_the_profilers():
    """A span around a ``torch.mm`` encloses the profiler's ``aten::mm``
    host event, both on ``time.time_ns``."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.microbatch(0, 128, (), 1, 0.0, torch.device("cpu")):
            with obs.span("forward"):
                torch.mm(a, a)
    (rec,) = obs.snapshot()["microbatches"]
    assert rec["profiled"] is True
    s = rec["spans"][1]
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert s["t0_ns"] <= start <= end <= s["t1_ns"]


class FakeEvent:
    """A stand-in for ``torch.cuda.Event``: ``record`` stamps the span
    clock, ``query`` is always done, ``elapsed_time`` is in ms."""

    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream):
        assert stream == "stream"
        self.t = obs._reg.clock()

    def query(self):
        return True

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def test_device_boundaries_gap_and_event_pool(monkeypatch):
    """With stand-in events: one event a span start, plus the ends of
    copy_out and of the microbatch; device ms between consecutive
    boundaries; the gap from one copy_out's end to the next copy_in's
    start; and events reused from the pool."""
    t = [0]

    def tick():
        t[0] += 1_000_000          # 1 ms a read
        return t[0]

    obs.use_clock(tick)
    FakeEvent.made = 0
    monkeypatch.setattr(obs._Registry, "new_event", staticmethod(FakeEvent))
    monkeypatch.setattr(obs, "_stream_of", lambda device: "stream")
    names = ("stack", "copy_in", "plan", "forward", "copy_out", "finish")
    for i in range(3):
        req = types.SimpleNamespace(rid=i, t_submit=0.0)
        obs.admitted(0, i, 0.0, obs.stamp())
        with obs.microbatch(0, 64, [req], 1, 0.0, "card"):
            for n in names:
                with obs.span(n):
                    if n == "forward":
                        with obs.span("sa0.sample"):
                            pass
    snap = obs.snapshot()
    recs = snap["microbatches"]
    for rec in recs:
        assert len(rec["device_ms"]) == len(rec["spans"]) + 1
        for k in range(len(rec["spans"])):
            host, dev = obs.span_ms(rec, k)
            # one clock: a span's end event is the next boundary's, at most
            # three reads after its host end
            assert 0 < host <= dev <= host + 3
    assert recs[0]["gap"] is None
    for prev, rec in zip(recs, recs[1:]):
        out = next(s for s in prev["spans"] if s["name"] == "copy_out")
        cin = next(s for s in rec["spans"] if s["name"] == "copy_in")
        assert rec["gap"]["host_ns"] == cin["t0_ns"] - out["t1_ns"]
        assert rec["gap"]["device_ms"] == pytest.approx(
            rec["gap"]["host_ns"] / 1e6, abs=2)
        # finish, admit and stack lie inside the gap: 1 ms each (their two
        # stamps are consecutive reads of the clock)
        assert rec["gap"]["program_ns"] == 3 * 1_000_000
    per = len(recs[0]["spans"]) + 2
    assert FakeEvent.made < 3 * per             # the pool was drawn on
    assert obs.phase_medians(0)["point_ops"]["device_ms"] > 0


def test_obs_has_its_zone_and_time_ns_is_a_wall_clock():
    assert zones.zone_of("src/repro_torch/obs.py") == "obs"
    assert zones.zone_of("src/repro_torch/serve/engine.py") == "serve"
    src = "import time\n\n\ndef f():\n    return time.time_ns()\n"
    rules = {z: [f.rule for f in walker.lint_source(
        f"# repolint: zone={z}\n" + src, "p.py")] for z in ("serve", "launch")}
    assert rules == {"serve": ["CLK001"], "launch": ["CLK003"]}
