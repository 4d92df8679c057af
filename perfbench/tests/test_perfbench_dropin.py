"""Later changes add cells, configurations, mixes and per-layer metrics
as new files and new entries of BENCHMARK.json: a copy with a tiny
configuration, mix, limits file and a new metric reader dropped in runs
them, and every file the benchmark had is left as it was."""
from __future__ import annotations

import filecmp
import json

from conftest import REPO, build_copy, last_line, run_cell

READER = '''"""answers_per_step.tiny: answers a serving step returned, on average."""


def read(record):
    steps, answered = record.get("service_s"), record.get("answered")
    return None if not steps or answered is None else answered / len(steps)
'''


def test_new_files_are_picked_up_by_name(tmp_path):
    root = build_copy(tmp_path)
    # a new metric: its reader file and its entry; the reader reads a key
    # the stream entry does not record, so it finds nothing and the
    # harness leaves the metric out of the line
    (root / "perfbench" / "metrics" / "answers_per_step.tiny.py").write_text(
        READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "answers_per_step.tiny", "unit": "answers", "better":
        "higher", "source": "host_clock", "layer": "serve engine",
        "moves": "latency_p50_ms", "workloads": ["tiny-ssg.blocks-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = run_cell(root, "tiny-ssg.blocks-tiny", seed=3, trace=1)
    assert rc == 0, err[-3000:]
    res = last_line(out)
    assert res["correct"] is True
    assert "service_ms_p50" in res["metrics"]
    assert "answers_per_step.tiny" not in res["metrics"]

    # and a reader that finds what it reads is reported under its name
    (root / "perfbench" / "metrics" / "answers_per_step.tiny.py").write_text(
        READER.replace('record.get("answered")',
                       'len(record["queue_wait_s"])'))
    rc, out, err = run_cell(root, "tiny-ssg.blocks-tiny", seed=3, trace=1)
    assert rc == 0, err[-3000:]
    m = last_line(out)["metrics"]["answers_per_step.tiny"]
    assert m["unit"] == "answers" and m["value"] >= 1.0

    # nothing the benchmark already had was edited
    def same(rel):
        return filecmp.cmp(REPO / rel, root / rel, shallow=False)
    for path in (REPO / "perfbench").rglob("*"):
        rel = path.relative_to(REPO)
        if path.is_file() and "tests" not in rel.parts \
                and "__pycache__" not in rel.parts:
            assert same(rel), rel
    old = json.loads((REPO / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in old[key]:
            new = next(e for e in bench[key] if e["name"] == entry["name"])
            extra = set(new.get("workloads", ())) - set(entry.get(
                "workloads", ()))
            assert {k: v for k, v in new.items() if k != "workloads"} == {
                k: v for k, v in entry.items() if k != "workloads"}
            assert all(w.startswith("tiny") for w in extra)
