"""Matmul FLOPs of one cloud through a PNN, counted from the
configuration's shapes (the matmul part of the program's
``launch/pnn_cell._model_flops``, with each FP stage at its own level's
point count).

Only the dense layers count: an SA stage's shared MLP runs on every one of
its ``nsample`` grouped rows of every sampled centre, an FP stage's on
every point of its level, the head and the output layer on every input
point.  Norms, pooling and the point ops are left out.
"""
from __future__ import annotations


def stage_sizes(n: int, stages) -> list:
    """Points at each level: ``n``, then each stage's round(rate * prev)."""
    sizes = [n]
    for s in stages:
        sizes.append(max(1, int(round(sizes[-1] * s["rate"]))))
    return sizes


def _mlp(rows: int, din: int, widths) -> tuple[float, int]:
    total = 0.0
    for w in widths:
        total += 2.0 * rows * din * w
        din = w
    return total, din


def seg_forward_flops(cfg: dict, n: int) -> float:
    """Matmul FLOPs of one ``n``-point cloud's segmentation forward."""
    stages, c_in = cfg["stages"], cfg["in_channels"]
    sizes = stage_sizes(n, stages)
    total = 0.0
    for i, s in enumerate(stages):
        f, _ = _mlp(sizes[i + 1] * s["nsample"], c_in + 3, s["widths"])
        total += f
        c_in = s["widths"][-1]
    skips = [cfg["in_channels"]] + [s["widths"][-1] for s in stages[:-1]]
    up = stages[-1]["widths"][-1]
    for i, widths in enumerate(cfg["fp_widths"]):
        level = len(stages) - 1 - i
        f, up = _mlp(sizes[level], up + skips[level], widths)
        total += f
    f, d = _mlp(n, up, cfg["head_widths"])
    return total + f + 2.0 * n * d * cfg["num_classes"]
