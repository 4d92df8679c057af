"""A copy of the benchmark with tiny cells dropped in, for the CPU tests.

The copy holds ``BENCHMARK.json`` and ``perfbench/`` as committed, the
program's ``src`` linked in, and new files only: a tiny configuration of
each committed one (the same keys, small widths), one tiny traffic file
per entry, a limits file a cell, plus the cells appended to the copy's
``BENCHMARK.json`` and to the ``workloads`` of the metrics they report.
No file the benchmark already has is edited.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_STAGES = [{"rate": 0.25, "radius": 0.4, "nsample": 8, "widths": [16]},
               {"rate": 0.25, "radius": 0.8, "nsample": 8, "widths": [16, 32]}]
TINY_TRAFFIC = {
    "rooms-tiny": {"entry": "offline_seg", "points": 1500, "extent": 1.0,
                   "microbatch": 2, "pool": 3, "room_seed": 1, "max_wait_s": 0.02,
                   "compare_rooms": 2, "trace_seconds": 1,
                   "reference_chunk": 64},
    "blocks-tiny": {"entry": "stream_seg", "points": 600, "extent": 0.5,
                    "block_scale": 0.4, "microbatch": 2, "max_wait_s": 0.02,
                    "rate_per_s": 12.0, "compare_requests": 4,
                    "warm_batches": 1, "trace_seconds": 1,
                    "reference_chunk": 64},
}
# tiny cell -> (tiny config, tiny traffic, the committed cell it mirrors)
TINY_CELLS = {
    "tiny-s.rooms-tiny": ("tiny-s", "rooms-tiny", "pointnext-s.rooms-289k"),
    "tiny-ssg.blocks-tiny": ("tiny-ssg", "blocks-tiny",
                             "pointnet2-ssg.blocks-4k"),
}


def build_copy(dest: Path) -> Path:
    """The tiny copy at ``dest``; returns it."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "src").symlink_to(REPO / "src")
    pb = dest / "perfbench"
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for cfg_name, base in (("tiny-s", "pointnext-s"),
                           ("tiny-ssg", "pointnet2-ssg")):
        cfg = json.loads((pb / "configs" / f"{base}.json").read_text())
        cfg.update(name=cfg_name, th=32, stages=TINY_STAGES,
                   fp_widths=[[16, 16], [16]], head_widths=[16])
        path = pb / "configs" / f"{cfg_name}.json"
        assert not path.exists()
        path.write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg_name, "source": "tiny",
                                 "file": f"perfbench/configs/{cfg_name}.json",
                                 "reduced": [], "why": "CPU tests"})
    for name, tr in TINY_TRAFFIC.items():
        path = pb / "traffic" / f"{name}.json"
        assert not path.exists()
        path.write_text(json.dumps(tr))
    for cell, (cfg_name, traffic, mirror) in TINY_CELLS.items():
        chips = next(c["chips"] for c in bench["workloads"]
                     if c["name"] == mirror)
        bench["workloads"].append({"name": cell, "config": cfg_name,
                                   "traffic": traffic, "chips": chips,
                                   "why": "CPU tests"})
        shutil.copy(pb / "limits" / f"{mirror}.json",
                    pb / "limits" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if mirror in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return build_copy(tmp_path_factory.mktemp("bench"))


def run_cell(root: Path, cell: str, *, seed=7, seconds=1.5, trace=0,
             extra=()):
    """``perfbench/run.py`` on the CPU in ``root``: (returncode, stdout,
    stderr)."""
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--device", "cpu", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    return p.returncode, p.stdout, p.stderr


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
