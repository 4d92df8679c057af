"""The knee of an open-loop stream cell: the highest offered rate the
system sustains, found once by a sweep on the chip (the cell then offers
a fixed share of it, written into its traffic file).

    python3 perfbench/sweep.py --workload pointnet2-ssg.blocks-4k \\
        --rates 8,12,16,20,24,28 --seconds 20 --seed 11

One engine, warmed once; each rate offers its own stream (the cell's
arrival rule at that rate) for ``--seconds``.  A rate is sustained when
the requests complete at 99 % of the rate offered or more, the backlog
does not grow (the median latency of the last quarter of the requests
is at most 1.25 times that of the first quarter) and the 95th percentile
stays under 400 ms.  The knee is the highest rate sustained.  One JSON
line a rate on standard output, copied to
``chiprun_out/sweep-<cell>.jsonl``.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402
from perfbench.yardstick.trace import Tracer  # noqa: E402

COMPLETED = 0.99     # completed / offered, at least
BACKLOG = 1.25       # last quarter's median latency / the first's, at most
P95_MS = 400.0       # 95th percentile latency, under


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    traffic = harness.traffic_of(cell["traffic"])
    device = torch.device(args.device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = harness.Context(cell=cell, config=harness.config_of(
        bench, cell["config"]), traffic=traffic, seed=args.seed,
        seconds=args.seconds, trace=False, device=device,
        chips=cell["chips"], t_start=T_START)
    entry = harness.entry_of(traffic)
    eng = entry.build(ctx, entry.weights_of(ctx))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = open(out_dir / f"sweep-{cell['name']}.jsonl", "a")
    for rate in (float(r) for r in args.rates.split(",")):
        due, clouds, _ = entry.inputs(ctx, rate)
        s = entry.stream(ctx, eng, clouds, due, Tracer(False, 0, ctx.sync))
        lat = s["latency_s"] * 1e3
        q = max(1, len(lat) // 4)
        first, last = np.median(lat[:q]), np.median(lat[-q:])
        p95 = float(np.percentile(lat, 95))
        row = {"workload": cell["name"], "offered_per_s": rate,
               "requests": len(due), "failed": s["failed"],
               "completed_per_s": len(lat) / s["window_s"],
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": p95,
               "first_quarter_p50_ms": float(first),
               "last_quarter_p50_ms": float(last),
               "sustained": bool(
                   len(lat) / s["window_s"] >= COMPLETED * rate
                   and last <= BACKLOG * first
                   and p95 < P95_MS)}
        if device.type == "cuda":
            row["card"] = torch.cuda.get_device_name(device)
        print(json.dumps(row), flush=True)
        log.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
