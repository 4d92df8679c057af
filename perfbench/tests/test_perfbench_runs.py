"""Each entry of the benchmark at tiny sizes on the CPU: a well-formed last
line, the cell's metrics by name, and no JAX or JAX package loaded."""
from __future__ import annotations

import json

import pytest

from conftest import TINY_CELLS, last_line, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _metrics(root, cell, kind):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return {m["name"]: m["unit"] for m in e2e}
    return {m["name"]: m["unit"] for m in bench["per_layer"]
            if cell in m.get("workloads", ())}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_entry_prints_a_well_formed_last_line(tiny, cell, trace):
    rc, out, err = run_cell(tiny, cell, seed=2**31 + 11, trace=trace)
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert set(KEYS) <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    chips = next(c["chips"] for c in bench["workloads"] if c["name"] == cell)
    assert res["device"]["platform"] == "cpu"
    assert res["device"]["count"] == chips
    want = _metrics(tiny, cell, "per_layer" if trace else "end_to_end")
    if trace:
        # the CPU has no device trace: the device's readers find nothing
        # and their metrics are left out; the host's are there
        assert set(res["metrics"]) <= set(want)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == set(want)
        assert all(v["value"] > 0 for v in res["metrics"].values())
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name]
    for name, c in res["checks"].items():
        assert f"check {name}: " in err
        assert c["value"] <= c["limit"]
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_no_jax_or_jax_package_loaded(tiny):
    """The run's own check: compared by whole top-level names, so the port
    (``repro_torch``) passes and the JAX package (``repro``) fails."""
    rc, out, err = run_cell(tiny, "tiny-s.rooms-tiny", seed=5)
    assert rc == 0, err[-3000:]
    from perfbench import harness
    import sys
    sys.modules["repro_torch_probe.x"] = sys
    try:
        assert "repro_torch_probe.x" not in harness.banned_modules()
        sys.modules["repro.probe"] = sys
        assert "repro.probe" in harness.banned_modules()
    finally:
        sys.modules.pop("repro_torch_probe.x", None)
        sys.modules.pop("repro.probe", None)


def test_run_refuses_without_a_card(tiny):
    """Without ``--device cpu`` a run needs the card: no result, exit 2."""
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "tiny-s.rooms-tiny", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny, capture_output=True,
                       text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, a run
    exits non-zero and prints no result."""
    import shutil
    from conftest import REPO
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench")
    rc, out, err = run_cell(tmp_path, "pointnet2-ssg.blocks-4k", seed=1)
    assert rc != 0 and out.strip() == ""
