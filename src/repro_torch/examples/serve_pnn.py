"""Batched point-cloud segmentation serving -- thin client of
``repro_torch.serve``.

Counterpart of ``examples/serve_pnn.py``.  A mixed-size request stream
flows through the serving engine: each cloud is padded to its minimal
shape bucket, a per-bucket queue packs fixed microbatches under a max-wait
deadline, and a plan cache keeps one partition plan per (bucket, th,
strategy) and one forward per (bucket, device).  First-use work (the
kernel build) happens in ``warm()``, before the stream, so reported
latencies never include it.  It prints the median host ms of a
microbatch and of its plan, point-op and MLP spans (``stats()["phases"]``,
from ``repro_torch.obs``), and on the card their device ms, the peak
device memory and each kernel's launches over the stream.  It runs on the
card unless asked for the CPU::

  PYTHONPATH=src python -m repro_torch.examples.serve_pnn \\
      [--buckets 1024,4096] [--requests 16] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import serve
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.dist import elastic, process
from repro_torch.kernels import ops


def run(cfg: serve.ServeConfig, clouds, *, params=None, seed: int = 0,
        device=None, log=print, mesh=None):
    """Warm an engine for ``cfg`` (weights ``params``, else drawn from
    ``seed``; on ``mesh`` where given), then serve ``clouds`` (an iterable
    of (n, 3) arrays, read one request at a time) in order: submit,
    dispatch what is ready, and flush at the end.  Every answer must be
    ``(n, num_classes)``.

    Returns (the printed numbers, the logits in request order)."""
    engine = serve.ServeEngine(cfg, params=params, seed=seed, device=device,
                               mesh=mesh)
    on_card = engine.device.type == "cuda"
    compile_s = engine.warm()
    log(f"warmed {len(compile_s)} buckets ({cfg.point_ops} point ops, "
        f"device={engine.device}, th={cfg.th}): "
        + ", ".join(f"n={b} in {s:.1f}s" for b, s in compile_s.items())
        + "  [excluded from latencies]")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    expect, order, results = {}, [], {}

    def collect(rids):
        for rid in rids:
            out = engine.take(rid)   # pop-on-read
            if out is None or out.shape != (expect[rid], cfg.num_classes):
                raise AssertionError(
                    f"request {rid}: result shape "
                    f"{None if out is None else out.shape}, want "
                    f"{(expect[rid], cfg.num_classes)}")
            results[rid] = out

    for coords in clouds:
        rid = engine.submit(coords)
        expect[rid] = len(coords)
        order.append(rid)
        collect(engine.step())
    collect(engine.flush())
    launches = ops.launch_counts()

    st = engine.stats()
    pc = st["plan_cache"]
    report = {"warm_s": dict(compile_s), "served": st["served"],
              "world_size": st["world_size"], "mesh": st["mesh"],
              "wall_s": st["wall_s"], "clouds_per_s": st["clouds_per_s"],
              "mpts_per_s": st["mpts_per_s"],
              "buckets": {b: {k: row[k] for k in
                              ("count", "p50_ms", "p95_ms", "p99_ms")}
                          for b, row in sorted(st["buckets"].items())},
              "executables": pc["executables"], "hits": pc["hits"],
              "misses": pc["misses"],
              "one_trace_per_key": all(v == 1
                                       for v in pc["traces"].values()),
              "phases": st["phases"]}
    if st["clouds_per_s"] is None:   # no microbatch completed
        log(f"served {st['served']} clouds (no completed window)")
    else:
        log(f"served {st['served']} clouds in {st['wall_s']:.2f}s: "
            f"{st['clouds_per_s']:.2f} clouds/s "
            f"({st['mpts_per_s']:.3g} Mpts/s)"
            + (f" on mesh {st['mesh']} of {st['world_size']} ranks"
               if st["mesh"] else ""))
    for b, row in report["buckets"].items():
        log(f"  bucket n={b}: {row['count']} clouds, "
            f"p50 {row['p50_ms']:.1f} / p95 {row['p95_ms']:.1f} / "
            f"p99 {row['p99_ms']:.1f} ms")
    log(f"plan cache: {pc['executables']} executables, {pc['hits']} hits, "
        f"{pc['misses']} misses (one trace per key: "
        f"{report['one_trace_per_key']})")
    if st["phases"]:
        log("median ms a microbatch (host / device): " + ", ".join(
            f"{p} {v['host_ms']:.2f} / "
            + ("-" if v["device_ms"] is None else f"{v['device_ms']:.2f}")
            for p, v in st["phases"].items()))
    if on_card:
        report["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        report["launches"] = launches
        log(f"peak device memory {report['peak_device_gib']:.2f} GiB; "
            f"kernel launches over the stream: {launches}")
    return report, [results[rid] for rid in order]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--buckets", default="1024,4096",
                    help="comma-separated shape-bucket ladder")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--th", type=int, default=256)
    ap.add_argument("--variant", default="pointnext",
                    choices=["pointnet2", "pointnext", "pointvector"])
    ap.add_argument("--point-ops", default="bppo",
                    choices=["bppo", "global"])
    ap.add_argument("--mesh", default="none", choices=["none", "auto"],
                    help="auto: shard microbatches over the process "
                         "world's (data, model) mesh (under torchrun)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> serve.ServeConfig:
    return serve.ServeConfig(
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        microbatch=args.microbatch, max_wait_s=args.max_wait_ms / 1e3,
        variant=args.variant, th=args.th, point_ops=args.point_ops,
        mesh=args.mesh)


def main(argv=None) -> dict:
    """Serve the stream; returns the numbers printed (rank 0 prints)."""
    args = parse(argv)
    cfg = config(args)
    mesh = (elastic.make_mesh(model_axis=cfg.model_axis, device=args.device)
            if cfg.mesh == "auto" else None)
    device = resolve_device(args.device) if mesh is None else mesh.device
    sizes = serve.mixed_request_sizes(cfg.buckets, args.requests, args.seed)
    clouds = (synthetic.segmentation_batch(args.seed, r, 1, n)[0][0].numpy()
              for r, n in enumerate(sizes))
    report, _ = run(cfg, clouds, seed=args.seed, device=device, mesh=mesh,
                    log=process.log_of(None if mesh is None else mesh.world))
    return report


if __name__ == "__main__":
    main()
