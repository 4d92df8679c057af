"""The InvResMLP entry (``entries/offline_seg_invres.py``) at a tiny size on
the CPU, dropped into the tiny copy of the benchmark as a later change
would add it: a tiny ``pointnext_invres`` configuration, mix, limits file
and cell.  Its last line is well formed and correct, names the cell's
metrics, its block readers find the program's block spans by name, a
fault in one block's residual makes the run incorrect, and the reference
computed in TF32 reads above the limit the program keeps."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, build_copy, last_line, run_cell

CELL, MIRROR = "tiny-xl.rooms-tiny-xl", "pointnext-xl.rooms-289k"
TINY = dict(th=32, stem_width=16, blocks=[2, 1],
            stages=[{"rate": 0.25, "radius": 0.4, "nsample": 8,
                     "widths": [16]},
                    {"rate": 0.25, "radius": 0.8, "nsample": 8,
                     "widths": [32]}],
            fp_widths=[[16, 16], [16, 16]], head_widths=[16])
TRAFFIC = {"entry": "offline_seg_invres", "points": 1500, "extent": 1.0,
           "microbatch": 2, "pool": 3, "room_seed": 1, "max_wait_s": 0.02,
           "compare_rooms": 2, "trace_seconds": 1, "reference_chunk": 64}

PLANTED = '''
import runpy, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
from repro_torch.models import pnn
first = []


def broken(self, gfeats, gmask, f):
    # the first block a forward runs (stage 0's block 0) drops its
    # residual: ReLU(h) in place of ReLU(f + h)
    if not first:
        first.append(self)
    g = pnn._pool(self.la(gfeats), gmask)
    h = self.pw2(self.pw1(g), act=False)
    return torch.relu(h if self is first[0] else f + h)


pnn.InvResMLP.forward = broken
sys.argv = ["perfbench/run.py"] + sys.argv[2:]
runpy.run_path(root + "/perfbench/run.py", run_name="__main__")
'''


@pytest.fixture(scope="module")
def tiny_xl(tmp_path_factory):
    root = build_copy(tmp_path_factory.mktemp("bench_xl"))
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "pointnext-xl.json").read_text())
    cfg.update(name="tiny-xl", **TINY)
    (pb / "configs" / "tiny-xl.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "rooms-tiny-xl.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(pb / "limits" / f"{MIRROR}.json",
                pb / "limits" / f"{CELL}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-xl", "source": "tiny",
                             "file": "perfbench/configs/tiny-xl.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-xl",
                               "traffic": "rooms-tiny-xl", "chips": 1,
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
def test_invres_entry_prints_a_well_formed_last_line(tiny_xl, trace):
    rc, out, err = run_cell(tiny_xl, CELL, seed=2**31 + 27, trace=trace)
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
        want = _declared(tiny_xl, "per_layer")
        assert {"res_point_ops_device_ms.seg",
                "res_mlp_device_ms.seg"} <= set(want)
        # the CPU has no device trace and no CUDA events: the device
        # metrics are left out, the host's and the program's are there
        assert {"step_mfu.seg", "leaf_fill.seg"} <= set(res["metrics"])
        assert set(res["metrics"]) <= set(want)
    else:
        want = _declared(tiny_xl, "end_to_end")
        assert set(res["metrics"]) == set(want) == {"setup_s",
                                                    "seg_points_per_s"}
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name]


def test_block_readers_find_the_block_spans(monkeypatch):
    """The two block readers read the program's own span names: given a
    record of a served microbatch with 1 ms between its boundaries, they
    count its search and gather spans, and its block layer spans."""
    import torch

    from perfbench import harness
    from perfbench.metrics import _program
    from repro_torch import obs

    bench = harness.benchmark()
    ctx = harness.Context(
        cell=harness.cell_of(bench, MIRROR),
        config={**harness.config_of(bench, "pointnext-xl"), **TINY},
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
    assert eng.stats()["model"] == {"res_queries": 2, "res_blocks": 3}
    rec = obs.snapshot()["microbatches"][-1]
    names = [s["name"] for s in rec["spans"]]
    assert {"sa0.res.group", "sa0.res0.group", "sa0.res1.mlp",
            "sa1.plan", "sa1.res.plan", "sa1.res0.mlp"} <= set(names)
    for k, s in enumerate(rec["spans"]):
        s["b0"], s["b1"] = k, k + 1
    rec["device_ms"] = [1.0] * len(rec["spans"])
    monkeypatch.setattr(_program, "snapshot", lambda: {"microbatches": [rec]})
    read = {m: harness.load_file(
        REPO / "perfbench" / "metrics" / f"{m}.py", m.replace(".", "_"))
        .read({}) for m in ("res_point_ops_device_ms.seg",
                            "res_mlp_device_ms.seg")}
    # searches: one a stage with blocks (2); gathers and layers: one a
    # block (3)
    assert read == {"res_point_ops_device_ms.seg": 5.0,
                    "res_mlp_device_ms.seg": 3.0}
    obs.reset()


def test_fault_in_one_block_residual_makes_the_run_incorrect(tiny_xl,
                                                             tmp_path):
    script = tmp_path / "planted.py"
    script.write_text(PLANTED)
    p = subprocess.run(
        [sys.executable, str(script), str(tiny_xl), "--workload", CELL,
         "--seed", "21", "--seconds", "1.5", "--trace", "0", "--device",
         "cpu"], cwd=tiny_xl, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    c = res["checks"]["logit_rel_err"]
    assert c["value"] > c["limit"]


def _calibrate(root, cell, *args):
    p = subprocess.run(
        [sys.executable, "perfbench/calibrate.py", "--workload", cell,
         *args], cwd=root, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]


def test_control_fails_the_limit_the_program_keeps(tiny_xl):
    """The reference in TF32 (on the CPU: operands rounded to its 10
    mantissa bits) reads above the limit; the program under it."""
    rows = _calibrate(tiny_xl, CELL, "--seconds", "1", "--seeds", "31",
                      "--control-seeds", "31,32", "--device", "cpu")
    limit = json.loads((tiny_xl / "perfbench" / "limits" / f"{CELL}.json")
                       .read_text())["logit_rel_err"]
    program = [r["program"] for r in rows if "program" in r]
    control = [r["control"] for r in rows if "control" in r]
    assert len(program) == 1 and len(control) == 2
    assert program[0]["logit_rel_err"] <= limit
    assert all(c["logit_rel_err"] > limit for c in control)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_control_fails_the_limit_on_the_card(card):
    rows = _calibrate(REPO, MIRROR, "--control-seeds", "41")
    limit = json.loads((REPO / "perfbench" / "limits" / f"{MIRROR}.json")
                       .read_text())["logit_rel_err"]
    assert rows[-1]["control"]["logit_rel_err"] > limit
