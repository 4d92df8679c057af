"""The readers of the program's own telemetry (``metrics/_program.py``):
None where the program recorded nothing or has no registry, the value
worked out by hand on a hand-made snapshot, and every host-side one in
the last line of a traced run of each tiny cell."""
from __future__ import annotations

import sys

import pytest

from conftest import TINY_CELLS, last_line, run_cell
from perfbench import harness
from perfbench.metrics import _program

MS = 1_000_000   # ns


def _span(name, parent, t0_ms, t1_ms, k):
    """A span whose device ms sit at boundary 2k (see ``_record``)."""
    return {"name": name, "parent": parent, "t0_ns": t0_ms * MS,
            "t1_ns": t1_ms * MS, "b0": 2 * k, "b1": 2 * k + 1}


def _record(spans, *, device, gap, fill, profiled=False):
    """A record whose span k's device ms are ``device`` x its host ms
    (``device`` None: read off the card), at boundary 2k."""
    spans = [_span(*s, k) for k, s in enumerate(spans)]
    dev = None
    if device is not None:
        dev = [0.0] * (2 * len(spans) - 1)
        for k, s in enumerate(spans):
            dev[2 * k] = device * (s["t1_ns"] - s["t0_ns"]) / MS
    return {"spans": spans, "device_ms": dev, "gap": gap, "leaf_fill": fill,
            "profiled": profiled}


# Host ms a class: plan 10 + 5, point ops 10 + 15 + 10, MLP 10 + 10 + 5,
# microbatch 100 (the first); plan 6, point ops 20, MLP 10, microbatch
# 50 (the second, read off the card); the third, made under a profiler,
# and its request are left out.
SNAP = {
    "counters": {"microbatches": 2, "slots": 8, "padded_slots": 3},
    "microbatches": [
        _record([("microbatch", -1, 0, 100), ("plan", 0, 10, 20),
                 ("forward", 0, 20, 90), ("sa0.sample", 2, 20, 30),
                 ("sa0.group", 2, 30, 45), ("sa0.mlp", 2, 45, 55),
                 ("sa1.plan", 2, 55, 60), ("fp0.interpolate", 2, 60, 70),
                 ("fp0.mlp", 2, 70, 80), ("head", 2, 80, 85),
                 ("finish", 0, 95, 99)],
                device=0.5, fill=0.16,
                gap={"host_ns": 40 * MS, "program_ns": 10 * MS,
                     "device_ms": 39.0}),
        _record([("microbatch", -1, 200, 250), ("plan", 0, 200, 206),
                 ("sa0.sample", 0, 206, 226), ("head", 0, 226, 236)],
                device=None, fill=None,
                gap={"host_ns": 20 * MS, "program_ns": 10 * MS,
                     "device_ms": None}),
        _record([("microbatch", -1, 300, 900), ("plan", 0, 300, 400),
                 ("sa0.sample", 0, 400, 700), ("head", 0, 700, 800)],
                device=1.0, fill=0.9, profiled=True,
                gap={"host_ns": 90 * MS, "program_ns": 90 * MS,
                     "device_ms": 90.0}),
    ],
    # waits 10, 20, ..., 200 ms; one request not yet dispatched; one
    # dispatched under a profiler, and one that queued behind it
    "requests": [{"rid": i, "t_submit": 1.0, "t_dispatch": 1.0 + 0.01 * i}
                 for i in range(1, 21)]
    + [{"rid": 21, "t_submit": 2.0, "t_dispatch": None},
       {"rid": 22, "t_submit": 2.0, "t_dispatch": 9.0, "profiled": True},
       {"rid": 23, "t_submit": 2.5, "t_dispatch": 9.5}],
}
EMPTY = {"counters": {"microbatches": 0, "slots": 0, "padded_slots": 0},
         "microbatches": [], "requests": []}
WANT = {
    "microbatch_host_ms.serve": 75.0,          # median of 100, 50
    "plan_host_ms.serve": 10.5,                # of 15, 6
    "point_ops_host_ms.serve": 27.5,           # of 35, 20
    "mlp_host_ms.serve": 17.5,                 # of 25, 10
    "engine_wait_ms_p95.serve": 190.5,         # 190 + 0.05 x 10
    "pad_share.serve": 37.5,                   # 3 / 8
    "plan_device_ms.seg": 7.5,                 # the first alone, x 0.5
    "point_ops_device_ms.seg": 17.5,
    "mlp_device_ms.seg": 12.5,
    "gap_device_ms.seg": 39.0,
    "gap_program_share.seg": 37.5,             # median of 25 %, 50 %
    "leaf_fill.seg": 16.0,
}
HOST_SIDE = {"tiny-ssg.blocks-tiny": [
    "microbatch_host_ms.serve", "plan_host_ms.serve",
    "point_ops_host_ms.serve", "mlp_host_ms.serve",
    "engine_wait_ms_p95.serve", "pad_share.serve"],
    "tiny-s.rooms-tiny": ["gap_program_share.seg", "leaf_fill.seg"]}
DEVICE_SIDE = ["plan_device_ms.seg", "point_ops_device_ms.seg",
               "mlp_device_ms.seg", "gap_device_ms.seg"]


def reader(name):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py",
                             "test_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_a_hand_made_snapshot(monkeypatch, name):
    r = reader(name)
    monkeypatch.setattr(_program, "snapshot", lambda: SNAP)
    assert r.read({}) == pytest.approx(WANT[name])
    monkeypatch.setattr(_program, "snapshot", lambda: EMPTY)
    assert r.read({}) is None
    monkeypatch.setattr(_program, "snapshot", lambda: None)
    assert r.read({}) is None


def test_no_registry_reads_none(monkeypatch):
    """A program without ``repro_torch.obs``: nothing to read, and no
    error."""
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    assert _program.snapshot() is None
    for name in WANT:
        assert reader(name).read({}) is None


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_traced_run_prints_the_host_side_metrics(tiny, cell):
    rc, out, err = run_cell(tiny, cell, seed=2**31 + 5, trace=1)
    assert rc == 0, err[-3000:]
    metrics = last_line(out)["metrics"]
    for name in HOST_SIDE[cell]:
        assert name in metrics, sorted(metrics)
        assert metrics[name]["unit"] == ("ms" if "_ms" in name else "%")
        assert metrics[name]["value"] >= 0
    assert not set(DEVICE_SIDE) & set(metrics)   # the CPU has no events
