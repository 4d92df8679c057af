"""Matmul FLOPs of one cloud through PointNeXt with InvResMLP blocks
(``reference/pointnext.py``), counted from the configuration's shapes as
``flops.py`` counts the other networks.

Only the dense layers count: the stem on every input point; an SA stage's
layers on each of the ``nsample`` grouped rows of every centre; a block's
local aggregation on each of the ``nsample`` grouped rows of every point
of its level, and its two pointwise layers on every point; an FP stage's
on every point of its level; the head and the output layer on every input
point.  Norms, pooling, the residual adds and the point ops are left out,
and so is the per-block neighbour search that the program runs once a
stage (it is no matmul).
"""
from __future__ import annotations

from perfbench.yardstick.flops import _mlp, stage_sizes


def block_flops(cfg: dict, n: int) -> list:
    """Matmul FLOPs of each stage's InvResMLP blocks, all of a stage
    together, for one ``n``-point cloud."""
    sizes = stage_sizes(n, cfg["stages"])
    out = []
    for i, (s, blocks) in enumerate(zip(cfg["stages"], cfg["blocks"])):
        m, c = sizes[i + 1], s["widths"][-1]
        la = 2.0 * m * s["nsample"] * (c + 3) * c
        pw = 2.0 * 2.0 * m * c * c * cfg["expansion"]
        out.append(blocks * (la + pw))
    return out


def seg_forward_flops(cfg: dict, n: int) -> float:
    """Matmul FLOPs of one ``n``-point cloud's segmentation forward."""
    stages = cfg["stages"]
    sizes = stage_sizes(n, stages)
    c0 = cfg["stem_width"]
    total = 2.0 * n * cfg["in_channels"] * c0 + sum(block_flops(cfg, n))
    c_in = c0
    for i, s in enumerate(stages):
        f, c_in = _mlp(sizes[i + 1] * s["nsample"], c_in + 3, s["widths"])
        total += f
    skips = [c0] + [s["widths"][-1] for s in stages[:-1]]
    up = stages[-1]["widths"][-1]
    for i, widths in enumerate(cfg["fp_widths"]):
        level = len(stages) - 1 - i
        f, up = _mlp(sizes[level], up + skips[level], widths)
        total += f
    f, d = _mlp(n, up, cfg["head_widths"])
    return total + f + 2.0 * n * d * cfg["num_classes"]
