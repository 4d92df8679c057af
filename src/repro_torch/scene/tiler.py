"""Scene tiler: coarse fractal pre-partition + halo rings.

Counterpart of ``repro.scene.tiler``.  A room-scale cloud (100k-1M points)
is cut into tiles by the same level-synchronous engine that builds the
model's blocks (``core/fractal.py``), run once at the coarse threshold
``tile_points``, on the device the scene lies on.  Two properties of that
tree do the work:

* tiles are DFT-contiguous: every coarse leaf is one contiguous slice of
  the sorted arrays, and its spatial neighbours sit in nearby slices, so
  halo candidates come from a bounded DFT window around the tile's range
  instead of a scan over all tiles;
* tiles are exact subtrees: a node's split depends only on the points
  inside it, never on ``th``, so re-partitioning a tile's points with the
  model's ``th`` and the tile's split phase (``dim0 = depth % 3``)
  re-derives the global subtree.

The partition's result is pulled to the host once; the per-tile
bookkeeping after it is numpy over O(tile + window) slices, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fractal


@dataclasses.dataclass(frozen=True)
class Tile:
    """One dispatchable unit of a scene: owned points + halo context."""

    tid: int               # compact tile id (coarse-DFT order)
    owned: np.ndarray      # (n_owned,) original indices, coarse-DFT order
    halo: np.ndarray       # (n_halo,) original indices (context only:
                           # present for neighbour search, never stitched)
    depth: int             # coarse-tree depth of the tile node
    lo: np.ndarray         # (3,) bbox min of the owned points
    hi: np.ndarray         # (3,) bbox max

    @property
    def dim0(self) -> int:
        """Split phase for re-partitioning: a node at depth d splits on
        dimension d % 3, so the tile's local level 0 must too."""
        return self.depth % 3

    @property
    def n_owned(self) -> int:
        return len(self.owned)

    @property
    def n(self) -> int:
        return len(self.owned) + len(self.halo)

    @property
    def indices(self) -> np.ndarray:
        """Tile-cloud gather indices: owned first (coarse-DFT order), halo
        appended -- the stitcher relies on this layout."""
        return np.concatenate([self.owned, self.halo])


@dataclasses.dataclass(frozen=True)
class ScenePlan:
    """The full tiling of one scene (every point owned by exactly one
    tile)."""

    n: int
    tile_points: int
    halo: float
    strategy: str
    tiles: tuple            # tuple[Tile, ...], coarse-DFT order
    overflowed: bool        # coarse tree hit its depth cap (oversize tiles)

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    @property
    def halo_points(self) -> int:
        return sum(len(t.halo) for t in self.tiles)

    @property
    def max_tile_n(self) -> int:
        return max((t.n for t in self.tiles), default=0)


def _bbox_dist(pts: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Euclidean distance of each point to an axis-aligned box (0 inside)."""
    d = np.maximum(np.maximum(lo - pts, pts - hi), 0.0)
    return np.sqrt((d * d).sum(-1))


def tile_scene(coords, *, tile_points: int, halo: float = 0.0,
               halo_window: int | None = None,
               max_halo_points: int | None = None,
               strategy: str = fractal.FRACTAL,
               depth: int | None = None) -> ScenePlan:
    """Cut one (n, 3) cloud (numpy, or a tensor on any device) into
    <= ``tile_points``-point tiles + halos.

    ``halo`` is a radius: points of other tiles within ``halo`` of a tile's
    bounding box join that tile's cloud as context, their outputs
    discarded at stitch time (the owner-tile rule).  Candidates come from a
    ``halo_window``-point DFT window on each side of the tile's range
    (default ``2 * tile_points``), capped at the ``max_halo_points``
    nearest (default ``tile_points // 4``).  ``halo=0`` disables halos.
    """
    if tile_points <= 0:
        raise ValueError(f"tile_points must be positive, got {tile_points}")
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    coords = torch.as_tensor(coords, dtype=torch.float32)
    n = coords.shape[0]
    part = fractal.partition(coords[None], th=tile_points, strategy=strategy,
                             depth=depth)

    # One host pull; everything after is numpy slices.
    host = {f: getattr(part, f)[0].cpu().numpy() for f in (
        "perm", "coords", "valid", "is_leaf", "leaf_start", "leaf_rsize",
        "leaf_vsize", "leaf_depth", "overflowed")}
    perm, sorted_pts, valid = host["perm"], host["coords"], host["valid"]
    starts, rsizes = host["leaf_start"], host["leaf_rsize"]
    vsizes, depths = host["leaf_vsize"], host["leaf_depth"]

    W = (2 * tile_points) if halo_window is None else int(halo_window)
    cap = (tile_points // 4) if max_halo_points is None else int(
        max_halo_points)

    tiles = []
    for i in np.nonzero(host["is_leaf"])[0]:
        s, r, v, d = (int(starts[i]), int(rsizes[i]), int(vsizes[i]),
                      int(depths[i]))
        if v == 0:
            continue  # invalid-only / empty leaf: nothing to own
        owned_pos = np.arange(s, s + v)
        tpts = sorted_pts[owned_pos]
        lo, hi = tpts.min(0), tpts.max(0)
        halo_ids = np.empty((0,), perm.dtype)
        if halo > 0 and cap > 0:
            cand = np.concatenate([np.arange(max(0, s - W), s),
                                   np.arange(s + r, min(n, s + r + W))])
            cand = cand[valid[cand]]
            if len(cand):
                dist = _bbox_dist(sorted_pts[cand], lo, hi)
                near = dist <= halo
                cand, dist = cand[near], dist[near]
                if len(cand) > cap:
                    cand = cand[np.argsort(dist, kind="stable")[:cap]]
                    cand.sort()  # keep the halo in DFT order
                halo_ids = perm[cand]
        tiles.append(Tile(tid=len(tiles), owned=perm[owned_pos],
                          halo=halo_ids, depth=d, lo=lo, hi=hi))
    return ScenePlan(n=n, tile_points=tile_points, halo=halo,
                     strategy=strategy, tiles=tuple(tiles),
                     overflowed=bool(host["overflowed"]))
