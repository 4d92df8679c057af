"""Matmul FLOPs of one cloud through Point Transformer
(``reference/point_transformer.py``), counted from the configuration's
shapes as ``flops.py`` counts the other networks.

Only the dense layers count, 2 * rows * din * dout each: level 0's first
layer on every input point; a TransitionDown's layer on each of the
``nsample`` grouped rows of every centre; in a block, ``linear1``, q, k, v
and ``linear3`` on every point of its level, and on each of the
``nsample`` neighbour rows of every point the position encoding (3 -> 3
-> C) and the weight encoding (C -> C / G -> C / G); a TransitionUp's two
layers on the points of the level each runs on (the last level's mean
layer once a cloud); the head and the output layer on every input point.
Norms, the softmax, the weighted sum, pooling, the residual adds and the
point ops are left out, and so are the per-layer neighbour searches that
the program runs once a level (they are no matmul).
"""
from __future__ import annotations


def level_sizes(cfg: dict, n: int) -> list:
    """Points at each level: ``n``, then round(prev / stride)."""
    sizes = [n]
    for s in cfg["strides"][1:]:
        sizes.append(max(1, int(round(sizes[-1] * (1.0 / s)))))
    return sizes


def block_flops(m: int, c: int, k: int, share: int) -> float:
    """One Point Transformer block on ``m`` points of ``c`` channels with
    ``k`` neighbours each."""
    pointwise = 5.0 * 2.0 * m * c * c          # linear1, q, k, v, linear3
    position = 2.0 * m * k * (3 * 3 + 3 * c)
    weight = 2.0 * m * k * (c * (c // share) + (c // share) ** 2)
    return pointwise + position + weight


def blocks_flops(cfg: dict, n: int) -> list:
    """Matmul FLOPs of each level's blocks, encoder and decoder together
    (the decoder's one a level), for one ``n``-point cloud."""
    sizes = level_sizes(cfg, n)
    return [cfg["blocks"][l]          # blocks[l] - 1, and the decoder's 1
            * block_flops(sizes[l], c, cfg["nsample"][l], cfg["share_planes"])
            for l, c in enumerate(cfg["planes"])]


def seg_forward_flops(cfg: dict, n: int) -> float:
    """Matmul FLOPs of one ``n``-point cloud's segmentation forward."""
    planes, ks = cfg["planes"], cfg["nsample"]
    sizes = level_sizes(cfg, n)
    total = (2.0 * n * cfg["in_channels"] * planes[0]
             + sum(blocks_flops(cfg, n)))
    for l in range(1, len(planes)):
        total += 2.0 * sizes[l] * ks[l] * (3 + planes[l - 1]) * planes[l]
    c = planes[-1]
    total += 2.0 * c * c + 2.0 * sizes[-1] * 2 * c * c      # the last level's
    for l in range(len(planes) - 1):
        total += (2.0 * sizes[l] * planes[l] * planes[l]
                  + 2.0 * sizes[l + 1] * planes[l + 1] * planes[l])
    c = planes[0]
    return total + 2.0 * n * c * c + 2.0 * n * c * cfg["num_classes"]
