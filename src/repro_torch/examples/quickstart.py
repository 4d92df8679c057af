"""Quickstart: Fractal partitioning + block-parallel point ops.

Counterpart of ``examples/quickstart.py`` with the batch axis the port's
``core`` takes (one cloud here).  It runs on the card unless asked for the
CPU::

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import core
from repro_torch.core import ref
from repro_torch.device import resolve_device

TH, RATE, BS, RADIUS, NUM, W = 256, 0.25, 256, 0.3, 16, 512


def cloud() -> np.ndarray:
    """The reference's clustered scene: two objects + clutter (the
    distribution Fractal's shape-aware splits exploit), 4096 points."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal([0, 0, 0], 0.3, (2000, 3)),
        rng.normal([3, 1, 0], 0.5, (1500, 3)),
        rng.uniform(-1, 4, (596, 3)),
    ]).astype(np.float32)


def run(pts: np.ndarray, device, log=print) -> dict:
    """Partition, sample, group and compare one (n, 3) cloud on
    ``device``; returns the printed numbers."""
    n = pts.shape[0]
    coords = torch.as_tensor(np.array(pts, np.float32), device=device)[None]

    # 1. Fractal: shape-aware, sorter-free partitioning (paper Alg. 1).
    part = core.partition(coords, th=TH)
    out = {"points": n, "blocks": int(part.num_leaves[0]),
           "max_leaf": int(part.max_leaf_vsize[0]),
           "traversals": int(part.traversals[0]),
           "sorts": int(part.sort_passes[0])}
    log(f"partitioned {n} points -> {out['blocks']} blocks "
        f"(max {out['max_leaf']} pts <= th={TH}), "
        f"{out['traversals']} traversals, {out['sorts']} sorts")

    # 2. Block-wise FPS: one fixed rate, fully parallel across blocks.
    samp = core.blockwise_fps(part, rate=RATE, k_out=n // 4, bs=BS)
    sval = samp.valid[0].cpu().numpy()
    out.update(sampled=int(sval.sum()), k_out=n // 4)
    log(f"sampled {out['sampled']}/{n // 4} points block-wise")

    # 3. Block-wise ball query: each center searches its parent window only.
    nb = core.blockwise_ball_query(part, samp, radius=RADIUS, num=NUM, w=W)
    cnt = nb.cnt[0].cpu().numpy()
    out["mean_cnt"] = float(cnt[sval].mean())
    log(f"grouping: mean {out['mean_cnt']:.1f} in-radius neighbors per "
        f"center")

    # 4. Compare against the global O(n^2) baseline (PointAcc-style).
    centers = part.coords[0][samp.idx[0][samp.valid[0]].long()]
    g_idx, g_cnt = ref.ball_query(
        part.coords, part.valid, centers[None],
        torch.ones((1, len(centers)), dtype=torch.bool, device=device),
        RADIUS, NUM)
    g_idx, g_cnt = g_idx[0].cpu().numpy(), g_cnt[0].cpu().numpy()
    b_idx = nb.idx[0].cpu().numpy()[sval]
    b_msk = nb.mask[0].cpu().numpy()[sval]
    recalls = [len(set(g_idx[i][:min(g_cnt[i], NUM)])
                   & set(b_idx[i][b_msk[i]])) / max(min(g_cnt[i], NUM), 1)
               for i in range(len(centers))]
    out["recall"] = float(np.mean(recalls))
    log(f"block-wise neighbor recall vs global search: "
        f"{out['recall'] * 100:.1f}% (paper: accuracy recovered by "
        f"retraining; see benchmarks/accuracy.py)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    return run(cloud(), resolve_device(args.device))


if __name__ == "__main__":
    main()
