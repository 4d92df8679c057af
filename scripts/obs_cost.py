"""The cost of the serving telemetry (``repro_torch.obs``), off and on, on
the card.

Two serving engines at the published widths of the repository's two
configurations (``perfbench/configs/``): PointNet++ SSG on 4,096-point
blocks, microbatch 4, timed on the host (a microbatch's ``step()``, the
logits copy included); PointNeXt-S on whole 289,000-point rooms,
microbatch 8, timed on the device (CUDA events around a microbatch's
``step()``).  Each runs ``--repeats`` microbatches with the registry off
and as many on, in turns (off, on, on, off, ...), after warm-up, and
reports each side's median and quartiles.  The registry's own host cost
is also timed alone: ``--repeats`` x 10 empty microbatches with a blocks
microbatch's spans (the logits copy and the leaf-fill read kept), on and
off in turns.  It also checks, on the card,
that a span around a matmul encloses the profiler's ``aten::mm`` host
event (the span clock is the profiler's) and prints each engine's
``stats()["phases"]``.

    PYTHONPATH=src python scripts/obs_cost.py [--repeats 40] [--json out]

It needs the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from repro_torch import obs, serve
from repro_torch.data import synthetic
from repro_torch.models import pnn

CONFIGS = Path(__file__).resolve().parent.parent / "perfbench" / "configs"
CELLS = {
    # config, points a cloud, extent, scale, microbatch, clock
    "blocks": ("pointnet2-ssg", 4096, 0.5, 0.4, 4, "host"),
    "rooms": ("pointnext-s", 289000, 6.0, 1.0, 8, "device"),
}


def engine(name: str, points: int, microbatch: int, device):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    stages = tuple(pnn.SAStage(s["rate"], s["radius"], s["nsample"],
                               tuple(s["widths"])) for s in cfg["stages"])
    fp = tuple(tuple(w) for w in cfg["fp_widths"])
    mcfg = pnn.PNNConfig(name=name, variant=cfg["variant"], task="seg",
                         num_classes=cfg["num_classes"], stages=stages,
                         fp_widths=fp, head_widths=tuple(cfg["head_widths"]),
                         point_ops="bppo", th=cfg["th"], n_points=points)
    scfg = serve.ServeConfig(
        buckets=(points,), microbatch=microbatch, max_wait_s=0.02,
        variant=cfg["variant"], task="seg", num_classes=cfg["num_classes"],
        th=cfg["th"], stages=stages, fp_widths=fp, on_overflow="silent")
    return serve.ServeEngine(scfg, params=pnn.init(mcfg), device=device)


def quartiles(xs) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return {"median": q2, "q1": q1, "q3": q3, "n": len(xs)}


def measure(cell: str, repeats: int, device) -> dict:
    name, n, extent, scale, mb, clock = CELLS[cell]
    eng = engine(name, n, mb, device)
    clouds = [(synthetic.scene(1000 + i, n, extent=extent, device=device)[0]
               * scale).cpu().numpy() for i in range(mb)]
    eng.warm()
    times = {False: [], True: []}
    order = [False, True, True, False] * ((repeats + 1) // 2)
    for warm in (True, False):
        for flag in (order[:4] if warm else order[:2 * repeats]):
            obs.enabled(flag)
            for c in clouds:
                eng.submit(c)
            torch.cuda.synchronize(device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            done = eng.step()
            ev[1].record()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize(device)
            if len(done) != mb:
                raise RuntimeError(f"{cell}: {len(done)} of {mb} served")
            if not warm:
                times[flag].append(host if clock == "host"
                                   else ev[0].elapsed_time(ev[1]))
    obs.enabled(True)
    off, on = quartiles(times[False]), quartiles(times[True])
    return {"clock": clock, "off_ms": off, "on_ms": on,
            "cost_share": on["median"] / off["median"] - 1.0,
            "phases": eng.stats()["phases"]}


def skeleton(device, logits, vsize) -> None:
    """One empty microbatch with a 4-stage, 4-FP-stage forward's spans."""
    with obs.microbatch(0, 4096, (), 4, 0.0, device):
        for name in ("stack", "copy_in", "plan"):
            with obs.span(name):
                pass
        with obs.span("forward"):
            for i in range(4):
                for k in ("plan", "sample", "group", "mlp")[i == 0:]:
                    with obs.span(f"sa{i}.{k}"):
                        pass
            for i in range(4):
                for k in ("interpolate", "mlp"):
                    with obs.span(f"fp{i}.{k}"):
                        pass
            with obs.span("head"):
                pass
        with obs.span("copy_out"):
            logits.cpu()
        with obs.span("finish"):
            obs.leaf_fill(vsize, 256)


def skeleton_cost(device, repeats: int) -> dict:
    """Host us of an empty microbatch, registry off and on, in turns."""
    logits = torch.zeros((4, 4096, 13), device=device)
    vsize = torch.ones((4, 64), dtype=torch.int32, device=device)
    times = {False: [], True: []}
    for i in range(4 * repeats + 8):
        flag = i % 4 in (1, 2)
        obs.enabled(flag)
        t0 = time.perf_counter()
        skeleton(device, logits, vsize)
        if i >= 8:
            times[flag].append((time.perf_counter() - t0) * 1e6)
    obs.enabled(True)
    off, on = quartiles(times[False]), quartiles(times[True])
    return {"off_us": off, "on_us": on,
            "cost_us": on["median"] - off["median"], "api_us": api_us(device)}


def api_us(device, n: int = 2000) -> dict:
    """Host us of one call of what a span does on the card."""
    stream = torch.cuda.current_stream(device)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    out = {}
    t0 = time.perf_counter()
    for ev in evs:
        ev.record(stream)
    out["event_record"] = (time.perf_counter() - t0) * 1e6 / len(evs)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for a, b in zip(evs, evs[1:]):
        a.elapsed_time(b)
    out["elapsed_time"] = (time.perf_counter() - t0) * 1e6 / n
    t0 = time.perf_counter()
    for _ in range(n):
        time.time_ns()
    out["time_ns"] = (time.perf_counter() - t0) * 1e6 / n
    return out


def clock_check(device) -> dict:
    """A span around a matmul on the card against the profiler's event."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(1024, 1024, device=device)
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with obs.microbatch(0, 1024, (), 1, 0.0, device):
            with obs.span("forward"):
                torch.mm(a, a)
        torch.cuda.synchronize(device)
    (rec,) = obs.snapshot()["microbatches"]
    s = rec["spans"][1]
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    return {"encloses": s["t0_ns"] <= start <= end <= s["t1_ns"],
            "span_ns": [s["t0_ns"], s["t1_ns"]], "mm_ns": [start, end],
            "device_ms": rec["device_ms"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--json", default=None, help="write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("obs_cost: no CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)   # one host thread: a steadier host
    out = {"device": torch.cuda.get_device_name(device),
           "torch": torch.__version__, "clock": clock_check(device)}
    obs.reset()
    out["skeleton"] = skeleton_cost(device, args.repeats)
    print("skeleton", json.dumps(out["skeleton"]), flush=True)
    for cell in CELLS:
        obs.reset()
        out[cell] = measure(cell, args.repeats, device)
        print(cell, json.dumps(out[cell]), flush=True)
    print("clock", json.dumps(out["clock"]), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
