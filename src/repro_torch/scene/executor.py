"""Scene executor: stream tiles through the bucketed serving engine.

Counterpart of ``repro.scene.executor``.  A ``SceneEngine``
owns a ``serve.ServeEngine`` and drives it with tiles instead of user
requests: each tile cloud (owned points + halo ring) is admitted to its
minimal shape bucket, packed into fixed microbatches and run by the
per-bucket cached forward.  Two scene-specific twists:

* every tile carries ``dim0 = tile.depth % 3``, so the partition plan
  re-derives the tile's global subtree;
* a microbatch is dispatched as soon as a bucket has a full one
  (``step()``), its results drained and stitched by the owner-tile rule,
  so what lives at once is one microbatch of tile tensors plus the (n,
  num_classes) output.  The executor never waits on a deadline, so it
  calls ``step()`` only when a bucket is full: on a mesh every ``step()``
  is a collective (rank 0's queue decides), and the calls that could
  dispatch nothing would only make the ranks wait for each other.

``mesh`` and ``model_axis`` go to the serving engine, as in the
reference: under torchrun every rank tiles and stitches the whole scene
on its host and serves its share of each microbatch's tiles, so every
rank's stitched logits are the same.  The reference's ``impl`` is not
carried over: the kernels follow the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import serve
from repro_torch.core import fractal
from repro_torch.scene import stitch as _stitch
from repro_torch.scene import tiler as _tiler


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Scene-inference knobs: tiling + the serve/model knobs they feed."""

    # Tiling (tiler.py).
    tile_points: int = 4096        # coarse partition threshold (tile size)
    halo: float = 0.1              # halo radius (0 = off)
    halo_window: int | None = None     # DFT candidate window (2*tile_points)
    max_halo_points: int | None = None  # halo cap (tile_points // 4)
    # Serving (serve/engine.py).
    buckets: tuple | None = None   # shape ladder; default derived from the
                                   # largest tile + halo cloud
    microbatch: int = 4            # tiles per dispatch
    # Model (models/pnn.py).
    variant: str = "pointnet2"
    num_classes: int = 6
    th: int = 256                  # model block threshold (<< tile_points)
    strategy: str = "fractal"
    point_ops: str = "bppo"        # bppo | global (global: no plan/dim0)
    leaf_chunk: int | None = None
    mesh: str = "none"             # none | auto (the process world's mesh)
    model_axis: int = 2
    stages: tuple | None = None    # override model stages (e.g. the
    fp_widths: tuple | None = None  # single-SA-stage scene_seg config)

    def max_tile_cloud(self) -> int:
        """Largest admissible tile cloud: owned + halo cap."""
        cap = (self.tile_points // 4 if self.max_halo_points is None
               else self.max_halo_points)
        return self.tile_points + (cap if self.halo > 0 else 0)


class SceneEngine:
    """Tile -> halo -> serve -> stitch for one model on one device
    (``device=None``: the card, raising where there is none), or on every
    rank of a mesh (``mesh``, else ``cfg.mesh="auto"``)."""

    def __init__(self, cfg: SceneConfig, params=None, seed: int = 0,
                 device=None, mesh=None):
        if cfg.tile_points <= cfg.th:
            raise ValueError(
                f"tile_points ({cfg.tile_points}) must exceed the model "
                f"block threshold th ({cfg.th}): tiles are re-partitioned "
                f"into th-point blocks")
        self.cfg = cfg
        top = cfg.max_tile_cloud()
        buckets = cfg.buckets or (max(top // 2, 1), top)
        self.serve_cfg = serve.ServeConfig(
            buckets=buckets, microbatch=cfg.microbatch,
            # The executor drives dispatch itself (step after submit, flush
            # at the end), so the deadline never gates a tile.
            max_wait_s=3600.0, variant=cfg.variant, task="seg",
            num_classes=cfg.num_classes, th=cfg.th, strategy=cfg.strategy,
            point_ops=cfg.point_ops, leaf_chunk=cfg.leaf_chunk,
            mesh=cfg.mesh, model_axis=cfg.model_axis, stages=cfg.stages,
            fp_widths=cfg.fp_widths)
        self.engine = serve.ServeEngine(self.serve_cfg, params=params,
                                        seed=seed, device=device, mesh=mesh)
        self.device = self.engine.device
        self.params = self.engine.params
        self.impl = self.engine.impl

    def warm(self, buckets=None) -> dict:
        """Run every bucket's plan + forward once (see ServeEngine.warm)."""
        return self.engine.warm(buckets)

    def plan(self, coords) -> _tiler.ScenePlan:
        """Tile one scene (no inference) on the engine's device."""
        coords = torch.as_tensor(coords, dtype=torch.float32)
        return _tiler.tile_scene(
            coords.to(self.device), tile_points=self.cfg.tile_points,
            halo=self.cfg.halo, halo_window=self.cfg.halo_window,
            max_halo_points=self.cfg.max_halo_points,
            strategy=self.cfg.strategy)

    def infer(self, coords, plan: _tiler.ScenePlan | None = None):
        """Segment one (n, 3) scene (numpy, or a tensor on any device);
        returns ((n, num_classes) float32 numpy logits, ScenePlan).

        Tiles stream through the serve queue: each full microbatch runs
        and is drained as it forms, so no more than one microbatch of
        padded tile tensors plus the output live at once."""
        if plan is None:
            plan = self.plan(coords)
        if plan.overflowed:
            # Fail fast with the actionable error, not a bucket-ladder
            # error mid-stream: an oversize coarse leaf means an
            # unsplittable (duplicate-heavy) region deeper than the cap.
            raise fractal.FractalOverflowError(
                f"coarse tiling overflowed: a tile kept more than "
                f"tile_points={self.cfg.tile_points} points at the depth "
                f"cap (n={plan.n}) -- the scene has an unsplittable "
                f"duplicate-heavy region; raise tile_points or dedupe")
        # Tile clouds are cut on the host: the queue holds host tensors and
        # moves each microbatch to the device in one copy.
        host = torch.as_tensor(coords, dtype=torch.float32).cpu().numpy()
        logits = np.zeros((plan.n, self.cfg.num_classes), np.float32)
        tiles = {t.tid: t for t in plan.tiles}
        rid_tid: dict[int, int] = {}
        seen = 0

        def drain(rids):
            nonlocal seen
            for rid in rids:
                tile = tiles[rid_tid.pop(rid)]
                seen += _stitch.stitch_tile(logits, tile,
                                            self.engine.take(rid))

        queue = self.engine.queue
        for tile in plan.tiles:
            rid = self.engine.submit(host[tile.indices], dim0=tile.dim0)
            rid_tid[rid] = tile.tid
            if any(queue.pending(b) >= queue.microbatch
                   for b in queue.policy.buckets):
                drain(self.engine.step())
        drain(self.engine.flush())
        if seen != plan.n:
            raise ValueError(f"tiles own {seen} points, scene has {plan.n}")
        return logits, plan

    def stats(self) -> dict:
        """Serve-layer stats (latencies, plan cache) of the tile stream."""
        return self.engine.stats()
