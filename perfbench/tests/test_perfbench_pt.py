"""The Point Transformer entry (``entries/offline_seg_pt.py``) at a tiny
size on the CPU, dropped into the tiny copy of the benchmark as a later
change would add it: a tiny ``point_transformer`` configuration, mix,
limits file and cell.  Its last line is well formed and correct and names
the cell's metrics, the attention and search readers find the program's
spans by name, a softmax over the channels in place of the neighbours
makes the run incorrect, and the reference computed in TF32 reads above
the limit the program keeps."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, build_copy, last_line, run_cell

CELL, MIRROR = "tiny-pt.rooms-tiny-pt", "point-transformer.rooms-289k"
TINY = dict(th=32, planes=[16, 16, 32, 32, 64], blocks=[2, 2, 2, 3, 2],
            nsample=[8, 16, 16, 16, 16])
TRAFFIC = {"entry": "offline_seg_pt", "points": 1500, "extent": 1.0,
           "microbatch": 2, "pool": 3, "room_seed": 1, "max_wait_s": 0.02,
           "compare_rooms": 2, "trace_seconds": 1, "reference_chunk": 64}

PLANTED = '''
import runpy, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
from repro_torch.core.fractal import take
from repro_torch.models import point_transformer as pt


def broken(self, f, nidx, mask, rel):
    # the attention weights' softmax over the channels, not the neighbours
    b, m, c = f.shape
    k, g = nidx.shape[-1], self.share
    q, kk, v = self.q(f), self.k(f), self.v(f)
    d = self.p2(self.p1(rel))
    s, t = self.bn_a.affine()
    a = torch.relu((take(kk, nidx) - q[:, :, None] + d) * s + t)
    w = torch.softmax(self.w2(self.w1(a)), dim=-1) * mask[..., None]
    y = (take(v, nidx) + d).view(b, m, k, g, c // g) * w[..., None, :]
    return y.sum(2).view(b, m, c)


pt.VectorAttention.forward = broken
sys.argv = ["perfbench/run.py"] + sys.argv[2:]
runpy.run_path(root + "/perfbench/run.py", run_name="__main__")
'''


@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    root = build_copy(tmp_path_factory.mktemp("bench_pt"))
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "point-transformer.json").read_text())
    cfg.update(name="tiny-pt", **TINY)
    (pb / "configs" / "tiny-pt.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "rooms-tiny-pt.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(pb / "limits" / f"{MIRROR}.json",
                pb / "limits" / f"{CELL}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-pt", "source": "tiny",
                             "file": "perfbench/configs/tiny-pt.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-pt",
                               "traffic": "rooms-tiny-pt", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if MIRROR in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _declared(root, kind):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"]: m["unit"] for m in bench[kind]
            if CELL in m.get("workloads", ())
            or (kind == "end_to_end" and "workloads" not in m)}


@pytest.mark.parametrize("trace", [0, 1])
def test_pt_entry_prints_a_well_formed_last_line(tiny_pt, trace):
    rc, out, err = run_cell(tiny_pt, CELL, seed=2**31 + 31, trace=trace)
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["checks"]) == {"logit_rel_err", "answers_failed"}
    # far inside the limit: the program and the reference agree to
    # float32 rounding on the CPU
    assert res["checks"]["logit_rel_err"]["value"] < 1e-5
    if trace:
        want = _declared(tiny_pt, "per_layer")
        assert {"attn_device_ms.seg", "pt_search_device_ms.seg"} <= set(want)
        # the CPU has no device trace and no CUDA events: the device
        # metrics are left out, the host's and the program's are there
        assert {"step_mfu.seg", "leaf_fill.seg"} <= set(res["metrics"])
        assert set(res["metrics"]) <= set(want)
    else:
        want = _declared(tiny_pt, "end_to_end")
        assert set(res["metrics"]) == set(want) == {"setup_s",
                                                    "seg_points_per_s"}
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name]


def test_pt_readers_find_the_attention_and_search_spans(monkeypatch):
    """The two readers read the program's own span names: given a record
    of a served microbatch with 1 ms between its boundaries, they count
    the attention layers' spans (one a block) and the searches' (one a
    level)."""
    import torch

    from perfbench import harness
    from perfbench.metrics import _program
    from repro_torch import obs

    bench = harness.benchmark()
    ctx = harness.Context(
        cell=harness.cell_of(bench, MIRROR),
        config={**harness.config_of(bench, "point-transformer"), **TINY},
        traffic=TRAFFIC, seed=3, seconds=1.0, trace=False,
        device=torch.device("cpu"), chips=1, t_start=0.0)
    entry = harness.entry_of(TRAFFIC)
    weights, rooms, _, _ = entry.inputs(ctx)
    obs.reset()
    eng = entry.engine(ctx, weights, bucket=TRAFFIC["points"], microbatch=2,
                       max_wait_s=0.02)
    for room in rooms[:2]:
        eng.submit(room)
    assert eng.step()
    # 1 + 1 + 1 + 2 + 1 encoder blocks and 5 decoder blocks
    assert eng.stats()["model"] == {"pt_searches": 5, "pt_blocks": 11}
    rec = obs.snapshot()["microbatches"][-1]
    names = [s["name"] for s in rec["spans"]]
    assert {"pt0.group", "pt3.enc1.attn", "pt0.dec.attn", "pt4.plan",
            "sa1.sample", "sa4.group", "fp.top.mlp", "fp3.interpolate",
            "stem.mlp", "head"} <= set(names)
    for k, s in enumerate(rec["spans"]):
        s["b0"], s["b1"] = k, k + 1
    rec["device_ms"] = [1.0] * len(rec["spans"])
    monkeypatch.setattr(_program, "snapshot", lambda: {"microbatches": [rec]})
    read = {m: harness.load_file(
        REPO / "perfbench" / "metrics" / f"{m}.py", m.replace(".", "_"))
        .read({}) for m in ("attn_device_ms.seg", "pt_search_device_ms.seg")}
    assert read == {"attn_device_ms.seg": 11.0,
                    "pt_search_device_ms.seg": 5.0}
    obs.reset()


def test_softmax_over_channels_makes_the_run_incorrect(tiny_pt, tmp_path):
    script = tmp_path / "planted.py"
    script.write_text(PLANTED)
    p = subprocess.run(
        [sys.executable, str(script), str(tiny_pt), "--workload", CELL,
         "--seed", "21", "--seconds", "1.5", "--trace", "0", "--device",
         "cpu"], cwd=tiny_pt, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    c = res["checks"]["logit_rel_err"]
    assert c["value"] > c["limit"]


def test_control_fails_the_limit_the_program_keeps(tiny_pt):
    """The reference in TF32 (on the CPU: operands rounded to its 10
    mantissa bits) reads above the limit; the program under it."""
    p = subprocess.run(
        [sys.executable, "perfbench/calibrate.py", "--workload", CELL,
         "--seconds", "1", "--seeds", "31", "--control-seeds", "31,32",
         "--device", "cpu"], cwd=tiny_pt, capture_output=True, text=True,
        timeout=900, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]
    limit = json.loads((tiny_pt / "perfbench" / "limits" / f"{CELL}.json")
                       .read_text())["logit_rel_err"]
    program = [r["program"] for r in rows if "program" in r]
    control = [r["control"] for r in rows if "control" in r]
    assert len(program) == 1 and len(control) == 2
    assert program[0]["logit_rel_err"] <= limit
    assert all(c["logit_rel_err"] > limit for c in control)
