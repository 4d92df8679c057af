"""Room-scale scene segmentation -- thin client of ``repro_torch.scene``.

Counterpart of ``examples/segment_scene.py``.  One 16k-1M-point synthetic
scene flows through the streaming scene path: a coarse fractal
pre-partition cuts it into DFT-contiguous tiles, each tile plus its halo
ring is admitted to a shape bucket and served by the plan-cached engine
(first use in ``warm()``), and per-point logits stitch back under the
owner-tile rule.  No O(n^2) op is ever materialized.  Besides the peak
host RSS it prints, on the card, the peak device memory of the
inference.  It runs on the card unless asked for the CPU::

  PYTHONPATH=src python -m repro_torch.examples.segment_scene \\
      [--n 65536] [--tile-points 4096] [--halo 0.15] [--device cpu]
"""
from __future__ import annotations

import argparse
import resource
import time

import numpy as np
import torch

from repro_torch import scene
from repro_torch.data import synthetic
from repro_torch.device import resolve_device


def run(coords, labels, cfg: scene.SceneConfig, *, params=None,
        seed: int = 0, device=None, log=print) -> dict:
    """Warm a ``SceneEngine`` for ``cfg`` (weights ``params``, else drawn
    from ``seed``), segment the (n, 3) scene ``coords`` (numpy, or a
    tensor on any device) and compare the argmax with ``labels``.
    Returns the printed numbers."""
    eng = scene.SceneEngine(cfg, params=params, seed=seed, device=device)
    on_card = eng.device.type == "cuda"
    t0 = time.monotonic()
    compile_s = eng.warm()
    log(f"warmed {len(compile_s)} buckets (device={eng.device}, "
        f"th={cfg.th}) in {time.monotonic() - t0:.1f}s  [excluded from "
        f"throughput]")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.monotonic()
    logits, plan = eng.infer(coords)
    dt = time.monotonic() - t0
    n = plan.n
    if logits.shape != (n, cfg.num_classes):
        raise AssertionError(f"logits {logits.shape}, want "
                             f"{(n, cfg.num_classes)}")
    owners = np.bincount(np.concatenate([t.owned for t in plan.tiles]),
                         minlength=n)
    out = {"points": n, "tiles": plan.num_tiles,
           "halo_points": plan.halo_points, "max_tile_n": plan.max_tile_n,
           "infer_s": dt, "points_per_s": n / dt,
           "owned_once": bool(len(owners) == n and (owners == 1).all()),
           "finite": bool(np.isfinite(logits).all())}
    log(f"tiled: {plan.num_tiles} tiles (<= {cfg.tile_points} owned pts "
        f"each), {plan.halo_points} halo context points, "
        f"max tile cloud {plan.max_tile_n}")
    log(f"inferred: {n / dt:,.0f} points/s ({dt:.2f}s end to end, "
        f"tiling + dispatch + stitch); every point owned by one tile: "
        f"{out['owned_once']}, logits finite: {out['finite']}")
    pred = logits.argmax(-1)
    labels = torch.as_tensor(labels).cpu().numpy()
    out["agreement"] = float((pred == labels).mean())
    out["class_counts"] = np.bincount(
        pred, minlength=cfg.num_classes).tolist()
    log(f"predictions (untrained params -- structure demo, not accuracy): "
        f"class counts {out['class_counts']}, label agreement "
        f"{out['agreement']:.3f}")
    out["peak_rss_mb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024
    log(f"peak RSS {out['peak_rss_mb']:.0f} MB "
        f"(~{1e6 * out['peak_rss_mb'] / n:.0f} bytes/point at this n)")
    if on_card:
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"peak device memory {out['peak_device_gib']:.2f} GiB "
            f"(inference)")
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--tile-points", type=int, default=4096)
    ap.add_argument("--halo", type=float, default=0.15,
                    help="halo radius (0 disables border context)")
    ap.add_argument("--th", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--variant", default="pointnet2",
                    choices=["pointnet2", "pointnext", "pointvector"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> scene.SceneConfig:
    return scene.SceneConfig(
        tile_points=args.tile_points, halo=args.halo, th=args.th,
        microbatch=args.microbatch, variant=args.variant)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    t0 = time.monotonic()
    coords, labels = synthetic.scene(args.seed, args.n, device=device)
    labels = labels.cpu()
    gen_s = time.monotonic() - t0
    print(f"scene: {args.n} points, {len(torch.unique(labels))} shape "
          f"classes ({gen_s:.1f}s to generate)")
    return {"generate_s": gen_s, **run(coords, labels, config(args),
                                        seed=args.seed, device=device)}


if __name__ == "__main__":
    main()
