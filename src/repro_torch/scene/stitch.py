"""Stitching: scatter per-tile outputs back to scene point order.

Counterpart of ``repro.scene.stitch``.  The owner-tile rule: every scene
point is owned by exactly one tile (the tiles are the leaves of one coarse
partition); any other tile that sees the point saw it as halo context, and
its output row for that point is discarded.  Tile clouds are submitted
owned-first (``Tile.indices``), so stitching is one scatter of each
output's owned prefix: no overlap pass, and the result does not depend on
the order in which tiles complete.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scene.tiler import ScenePlan


def stitch_tile(out: np.ndarray, tile, rows) -> int:
    """Scatter one tile's owned-prefix rows into ``out``; returns the
    number of points written.  The one place the owner-tile rule is
    applied."""
    rows = np.asarray(rows)
    if rows.shape[0] != tile.n:
        raise ValueError(
            f"tile {tile.tid}: expected {tile.n} rows "
            f"({tile.n_owned} owned + {len(tile.halo)} halo), "
            f"got {rows.shape[0]}")
    out[tile.owned] = rows[:tile.n_owned]
    return tile.n_owned


def stitch(plan: ScenePlan, outputs: dict, width: int,
           dtype=np.float32) -> np.ndarray:
    """Assemble per-tile per-point rows into one (n, width) scene array;
    ``outputs[tid]`` holds tile ``tid``'s (tile.n, width) rows in
    ``Tile.indices`` order.  Halo rows are dropped."""
    out = np.zeros((plan.n, width), dtype)
    seen = sum(stitch_tile(out, tile, outputs[tile.tid])
               for tile in plan.tiles)
    if seen != plan.n:
        raise ValueError(f"tiles own {seen} points, scene has {plan.n}")
    return out


def owner_of(plan: ScenePlan) -> np.ndarray:
    """(n,) id of the tile owning each scene point (-1 if none)."""
    owner = np.full((plan.n,), -1, np.int32)
    for tile in plan.tiles:
        owner[tile.owned] = tile.tid
    return owner
