"""Readings that the cells' limits and sizes are set from, many seeds in
one process (the benchmark's own runs never run this).

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \\
        [--seeds 1,2,...] [--control-seeds 7,8,9] [--probe 16,8,4]

* ``--seeds``: the cell's own run (set-up, a window of ``--seconds``, the
  comparison) on each seed: the program's readings, the lower end of each
  limit;
* ``--control-seeds``: the control on each seed: the reference computed in
  the next precision below the configuration's (TF32), put in the
  program's place on the same inputs: the upper end;
* ``--probe``: the peak device memory of one microbatch of each size
  (a closed-loop cell's microbatch is the largest under 70 GiB);
* ``--fault``: a fault of ``faults.py`` planted in the program for the
  ``--seeds`` runs, for the readings a fault gives.

A cell of several cards runs it under ``torch.distributed.run``, one
process a card; rank 0 reports.

One JSON line a reading on standard output, copied to
``chiprun_out/calibrate-<cell>.jsonl`` under the checkout.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

MEM_LIMIT = 70 * 2**30


def ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--probe", type=ints, default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.fault:
        from perfbench import faults
        faults.plant(args.fault)

    import torch
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    config = harness.config_of(bench, cell["config"])
    traffic = harness.traffic_of(cell["traffic"])
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = harness.entry_of(traffic)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = open(out_dir / f"calibrate-{cell['name']}.jsonl", "a")

    def emit(row):
        row = {"workload": cell["name"], **row}
        if device.type == "cuda":
            row["card"] = torch.cuda.get_device_name(device)
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    def context(seed, tr=traffic):
        return harness.Context(cell=cell, config=config, traffic=tr,
                               seed=seed,
                               seconds=args.seconds, trace=False,
                               device=device, chips=cell["chips"],
                               t_start=time.monotonic())

    for mb in args.probe:
        from perfbench import serving
        tr = dict(traffic, microbatch=mb)
        ctx = context(1, tr)
        weights, rooms, _, _ = entry.inputs(ctx)
        torch.cuda.reset_peak_memory_stats(device)
        eng = serving.engine(ctx, weights, bucket=tr["points"],
                             microbatch=mb, max_wait_s=tr["max_wait_s"])
        for i in range(mb):
            eng.submit(rooms[i % len(rooms)])
        t = time.monotonic()
        try:
            eng.step()
            fits = None
        except torch.OutOfMemoryError:
            fits = False
        t = time.monotonic() - t
        peak = torch.cuda.max_memory_allocated(device)
        emit({"probe_microbatch": mb, "peak_bytes": peak,
              "fits": peak < MEM_LIMIT if fits is None else fits,
              "first_step_s": t})
        del eng, weights, rooms
        torch.cuda.empty_cache()

    for seed in args.seeds:
        ctx = context(seed)
        res = entry.run(ctx)
        if res.get("rank", 0) != 0:
            continue
        emit({"seed": seed, "fault": args.fault, "program": res["readings"],
              "end_to_end": res["end_to_end"], "attempted": res["attempted"],
              "failed": res["failed"],
              "memory_peak_bytes": res["memory_peak_bytes"]})
        del res
        torch.cuda.empty_cache()

    for seed in args.control_seeds:
        emit({"seed": seed, "control": entry.control(context(seed))})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
