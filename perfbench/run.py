"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It loads and warms up the cell's
configuration (weights from the seed, on the card), measures for
``--seconds``, checks what the window produced against the plain
reference, and prints as its last line one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its
limit, which also close standard error.

A cell on several cards starts one process a card itself, through
``torch.distributed.run`` on a free port, each running this file; rank 0
prints the result line and the others print nothing.

It refuses (exit 2, no result) to run without as many CUDA cards as the
cell asks for, and fails (exit 3, no result) if the JAX package or JAX
was loaded.  ``--device cpu`` runs the plain versions at the sizes of the
given files, for the tests: its numbers are not device numbers.
"""
import os
import time

# The process's start (the launcher's, on a cell of several cards; the
# monotonic clock is one clock for every process of the host).
T_START = float(os.environ.get("PERFBENCH_T_START", time.monotonic()))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default=None,
                    help="cpu: the plain versions, for the tests")
    return ap.parse_args(argv)


def fail(code: int, msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    config = harness.config_of(bench, cell["config"])
    traffic = harness.traffic_of(cell["traffic"])
    limits = harness.limits_of(cell["name"])

    import torch
    if args.device is None:
        if not torch.cuda.is_available():
            fail(2, "no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            fail(2, f"{cell['name']} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} present")
    if cell["chips"] > 1 and "LOCAL_RANK" not in os.environ:
        return launch(cell["chips"], argv)
    if args.device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    else:
        device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)   # one host thread: a steadier host

    ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device,
                          chips=cell["chips"], t_start=T_START)
    res = harness.entry_of(traffic).run(ctx)
    if res.get("rank", 0) != 0:
        return 0

    loaded = harness.banned_modules()
    if loaded:
        fail(3, "the run loaded " + ", ".join(loaded))
    checks = harness.checks_of(res["readings"], limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": harness.is_correct(checks),
           "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        trace = res["record"].get("trace") or {}
        dev["busy_s"] = trace.get("busy_s", 0.0)
        dev["window_s"] = trace.get("window_s", 0.0)
        per_layer = harness.metrics_of(bench, cell["name"], "per_layer")
        out["metrics"] = harness.read_per_layer(per_layer, res["record"])
        out["breakdown"] = {"device_ops": trace.get("device_ops", []),
                            "idle_gaps": trace.get("idle_gaps", [])}
    else:
        e2e = harness.metrics_of(bench, cell["name"], "end_to_end")
        out["metrics"] = {m["name"]: {"value": float(res["end_to_end"][m["name"]]),
                                      "unit": m["unit"]} for m in e2e}
    out["device"] = dev
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def launch(ranks: int, argv=None) -> int:
    """Run this file once a card under ``torch.distributed.run`` and wait
    for every rank; returns the first failing rank's code, else 0."""
    env = dict(os.environ, PERFBENCH_T_START=repr(T_START))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ranks}", str(Path(__file__).resolve()),
           *(sys.argv[1:] if argv is None else argv)]
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
