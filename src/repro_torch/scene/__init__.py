"""repro_torch.scene -- streaming room-scale scene segmentation on one card.

Counterpart of ``repro.scene``.  Tile -> halo -> stitch: a 100k-1M-point
scene is cut into DFT-contiguous fractal tiles (``tiler``), each tile plus
a halo ring of border context streams through the bucketed serving engine
(``executor`` on top of ``repro_torch.serve``), and per-point
segmentation logits scatter back to scene order under the owner-tile rule
(``stitch``).  No O(n^2) op is ever materialized.
"""
from repro_torch.scene.executor import SceneConfig, SceneEngine
from repro_torch.scene.stitch import owner_of, stitch, stitch_tile
from repro_torch.scene.tiler import ScenePlan, Tile, tile_scene

__all__ = [
    "SceneConfig", "SceneEngine", "ScenePlan", "Tile", "owner_of",
    "stitch", "stitch_tile", "tile_scene",
]
