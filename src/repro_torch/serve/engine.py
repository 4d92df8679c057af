"""The PNN serving engine: admission -> queue -> plan -> forward.

Counterpart of ``repro.serve.engine``:

* admission pads each cloud to its minimal shape bucket (``bucketing``);
* a per-bucket microbatch queue packs requests under a max-wait deadline
  (``batching``); partial batches are padded with all-invalid clouds, so a
  bucket's forward always sees one shape;
* a plan cache holds one partition plan per (bucket, th, strategy) and one
  forward per (bucket, impl) (``plan_cache``); with ``point_ops="global"``
  there is no plan: the forward runs the O(n^2) global ops on the padded
  clouds and ignores ``dim0``;
* a microbatch runs as one batched forward: the partition and every point
  op work on ``(B, n, ...)``, and each kernel launches once per stage over
  the ``B * ML`` leaf blocks of the microbatch;
* with ``mesh="auto"`` (or a ``mesh``) the engine runs SPMD over the
  ranks of the process world, one process a card: every rank runs the
  same engine and gets the same ``submit``s, each runs the plan and the
  forward on its share of the microbatch's clouds (``"batch"`` over the
  data axes, where the microbatch divides them) with the leaf blocks over
  ``"model"`` (``core/bppo.py``), and the logits are all-gathered, so
  every rank's ``results`` are the one-card engine's.  Rank 0's queue
  decides which microbatches are due and the others take the same ones,
  so a clock read at another instant cannot split the ranks.

The forward reads nothing back to the host.  The one sync of a microbatch
is the copy of its logits to the host; the partition-overflow check runs
after it.  Each microbatch and each request leaves a record in
``repro_torch.obs`` (spans of its phases, its padding, its wait);
``stats()["phases"]`` gives their medians.  Entry points run on the card
(``device=None`` resolves to ``cuda`` and raises where there is none);
pass ``device="cpu"`` for the plain versions.  The engine is synchronous
and deterministic: time enters only through its clock (injectable for
tests).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import fractal
from repro_torch.device import resolve_device
from repro_torch.dist import elastic, logical, process
from repro_torch.models import pnn
from repro_torch.serve.batching import MicroBatch, MicroBatchQueue
from repro_torch.serve.bucketing import DEFAULT_BUCKETS, BucketPolicy
from repro_torch.serve.plan_cache import PlanCache


# ServeConfig's overrides of the model's structure.
MODEL_FIELDS = ("stages", "fp_widths", "head_widths", "blocks", "expansion",
                "stem_width", "normalize_dp", "norm", "radius_scaling",
                "stem_k", "enc_blocks", "share_planes")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-time knobs (model structure + admission + dispatch)."""

    buckets: tuple = DEFAULT_BUCKETS
    microbatch: int = 4
    max_wait_s: float = 0.02       # deadline for partial microbatches
    variant: str = "pointnet2"     # pointnet2 | pointnext | pointvector
                                   # | pointnext_invres | point_transformer
    task: str = "seg"              # cls | seg
    num_classes: int = 6
    th: int = 256                  # fractal threshold (plan-cache key part)
    strategy: str = "fractal"      # partition strategy (plan-cache key part)
    point_ops: str = "bppo"        # bppo | global (global: no plan/dim0)
    leaf_chunk: int | None = None
    mesh: str = "none"             # none | auto (the process world's mesh)
    model_axis: int = 2            # elastic mesh model-axis request
    # Overrides of the PNNConfig fields of the same names (None: its
    # default).
    stages: tuple | None = None
    fp_widths: tuple | None = None
    head_widths: tuple | None = None
    blocks: tuple | None = None          # InvResMLP blocks a stage
    expansion: int | None = None
    stem_width: int | None = None
    normalize_dp: bool | None = None
    norm: str | None = None
    radius_scaling: float | None = None
    stem_k: int | None = None            # point_transformer's structure
    enc_blocks: tuple | None = None
    share_planes: int | None = None
    on_overflow: str = "warn"      # partition overflow: warn | silent


class ServeEngine:
    """Shape-bucketed, plan-cached PNN serving on one card, or SPMD over a
    mesh of cards (``mesh``, else ``cfg.mesh="auto"``: the process world's
    elastic mesh; its device is this rank's card, or the CPU where
    ``device="cpu"``)."""

    def __init__(self, cfg: ServeConfig, params: pnn.PNN | None = None,
                 seed: int = 0, clock=time.monotonic, device=None,
                 mesh=None):
        self.cfg = cfg
        if cfg.mesh not in ("none", "auto"):
            raise ValueError(f"mesh must be 'none' or 'auto', got "
                             f"{cfg.mesh!r}")
        if mesh is None and cfg.mesh == "auto":
            mesh = elastic.make_mesh(model_axis=cfg.model_axis,
                                     device=device)
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.device)
        # The forward's kernels follow the device: "cuda" launches the
        # hand-written kernels, "plain" runs their PyTorch versions.
        self.impl = "cuda" if self.device.type == "cuda" else "plain"
        self.policy = BucketPolicy(cfg.buckets)
        self.queue = MicroBatchQueue(self.policy, cfg.microbatch,
                                     cfg.max_wait_s)
        self.plans = PlanCache()
        self._clock = clock
        self._obs = obs.new_owner()
        overrides = {k: getattr(cfg, k) for k in MODEL_FIELDS
                     if getattr(cfg, k) is not None}
        self._base = pnn.PNNConfig(
            name=f"serve_{cfg.variant}_{cfg.task}", variant=cfg.variant,
            task=cfg.task, num_classes=cfg.num_classes,
            n_points=self.policy.buckets[0], point_ops=cfg.point_ops,
            th=cfg.th, strategy=cfg.strategy, leaf_chunk=cfg.leaf_chunk,
            **overrides)
        if params is None:
            params = pnn.init(self._base,
                              torch.Generator().manual_seed(seed))
        self.params = params.to(self.device)
        self.results: dict[int, np.ndarray] = {}
        self._lat: dict[int, list] = {b: [] for b in self.policy.buckets}
        self.compile_s: dict[int, float] = {}
        self._t_first: float | None = None
        self._t_last: float | None = None

    # -- plan and forward -------------------------------------------------

    def _model_cfg(self, bucket: int) -> pnn.PNNConfig:
        return dataclasses.replace(self._base, n_points=bucket)

    def _plan_fn(self, bucket: int):
        key = ("plan", bucket, self.cfg.th, self.cfg.strategy)
        th, strategy = self.cfg.th, self.cfg.strategy

        def build():
            # dim0 is a (B,) tensor input, so phasing the split cycle per
            # cloud (scene tiles) reuses the one plan.  The overflow check
            # runs on the host after the microbatch completes (_execute).
            def plan(clouds, valid, dim0):
                return fractal.partition(clouds, valid, th=th,
                                         strategy=strategy, dim0=dim0,
                                         on_overflow="silent")
            return plan

        return self.plans.get(key, build)

    def _serve_fn(self, bucket: int):
        key = ("serve", bucket, self.impl)
        mcfg = self._model_cfg(bucket)

        def build():
            def step(params, clouds, valid, part):
                return pnn.apply(params, mcfg, clouds, valid=valid,
                                 part0=part)
            return step

        return self.plans.get(key, build)

    def _forward(self, bucket, clouds, valid, dim0):
        """One microbatch on the device; returns (logits of every cloud,
        this rank's partition), the partition None for the global ops,
        which have no plan."""
        with torch.inference_mode(), logical.mesh_rules(self.mesh):
            b = clouds.shape[0]
            clouds, valid, dim0 = (logical.shard(t, 0, "batch")
                                   for t in (clouds, valid, dim0))
            part = None
            if self.cfg.point_ops == "bppo":
                with obs.span("plan"):
                    part = self._plan_fn(bucket)(clouds, valid, dim0)
            with obs.span("forward"):
                out = self._serve_fn(bucket)(self.params, clouds, valid, part)
                out = logical.unshard(out, 0, "batch", b)
        return out, part

    # -- serving ----------------------------------------------------------

    def warm(self, buckets=None) -> dict[int, float]:
        """Run every bucket's plan + forward once on an all-invalid
        microbatch (the filler of partial batches), so request latencies
        exclude first-use costs such as the kernel build.  Returns
        {bucket: seconds}."""
        # Deliberately real wall time, not self._clock(): an injected
        # logical clock cannot time real first-use work.
        mb = self.queue.microbatch
        for b in (buckets if buckets is not None else self.policy.buckets):
            t0 = time.monotonic()  # repolint: disable=CLK001
            clouds = torch.zeros((mb, b, 3), device=self.device)
            valid = torch.zeros((mb, b), dtype=torch.bool, device=self.device)
            dim0 = torch.zeros((mb,), dtype=torch.int64, device=self.device)
            out, _ = self._forward(b, clouds, valid, dim0)
            out.cpu()
            self.compile_s[b] = time.monotonic() - t0  # repolint: disable=CLK001
        return dict(self.compile_s)

    def submit(self, coords, now: float | None = None, dim0: int = 0) -> int:
        """Admit one (n, 3) cloud (array or tensor); returns the request
        id.  ``dim0`` phases the cloud's partition plan."""
        now = self._clock() if now is None else now
        t_admit = obs.stamp()
        coords = torch.as_tensor(np.asarray(coords, dtype=np.float32))
        req = self.queue.submit(coords, now, dim0=dim0)
        obs.admitted(self._obs, req.rid, now, t_admit)
        if self._t_first is None:
            self._t_first = now
        return req.rid

    def step(self, now: float | None = None) -> list[int]:
        """Dispatch every microbatch ready at ``now`` (full, or past its
        deadline).  Returns the completed request ids; an injected ``now``
        stamps the completions."""
        done = []
        t = self._clock() if now is None else now
        for mb in self._due(t):
            done.extend(self._execute(mb, t, now=now))
        return done

    def _due(self, now: float) -> list:
        """The microbatches due at ``now``.  On a mesh of several ranks,
        rank 0's queue decides and the others take the same ones from
        theirs, which hold the same requests."""
        world = None if self.mesh is None else self.mesh.world
        if world is None or world.size == 1:
            return self.queue.ready(now)
        mbs = self.queue.ready(now) if world.rank == 0 else []
        due = process.broadcast_object(
            world, [(mb.bucket, len(mb.requests), mb.deadline_flush)
                    for mb in mbs])
        return mbs if world.rank == 0 else [self.queue.pop(*d) for d in due]

    def flush(self, now: float | None = None) -> list[int]:
        """Drain the queue (end of stream), deadline or not."""
        done = []
        t = self._clock() if now is None else now
        for mb in self.queue.drain():
            done.extend(self._execute(mb, t, now=now))
        return done

    def take(self, rid: int, default=None):
        """Pop a completed result."""
        return self.results.pop(rid, default)

    def _execute(self, mb: MicroBatch, t_dispatch: float,
                 now: float | None = None) -> list[int]:
        """Run one microbatch, dispatched at ``t_dispatch``.  With an
        injected ``now`` completions are stamped with it; otherwise the
        engine clock is read after the logits reach the host."""
        bucket, reqs = mb.bucket, mb.requests
        size = self.queue.microbatch
        with obs.microbatch(self._obs, bucket, reqs, size, t_dispatch,
                            self.device):
            with obs.span("stack"):
                npad = size - len(reqs)
                clouds = torch.stack([r.coords for r in reqs]
                                     + [torch.zeros((bucket, 3))] * npad)
                valid = torch.stack(
                    [r.valid for r in reqs]
                    + [torch.zeros((bucket,), dtype=torch.bool)] * npad)
                dim0 = torch.tensor([r.dim0 for r in reqs] + [0] * npad)
            with obs.span("copy_in"):
                clouds, valid, dim0 = (t.to(self.device)
                                       for t in (clouds, valid, dim0))
            out, part = self._forward(bucket, clouds, valid, dim0)
            with obs.span("copy_out"):
                out = out.cpu().numpy()           # the microbatch's one sync
            with obs.span("finish"):
                rids = self._finish(bucket, reqs, out, part, now)
        return rids

    def _finish(self, bucket, reqs, out, part, now) -> list[int]:
        """The overflow check and the results of a microbatch whose
        logits ``out`` are on the host."""
        t_done = self._clock() if now is None else now
        if part is not None:
            if self.cfg.on_overflow == "warn":
                fractal.warn_if_overflowed(
                    part, th=self.cfg.th,
                    depth=fractal.default_depth(bucket, self.cfg.th))
            obs.leaf_fill(part.leaf_vsize, self.cfg.th)
        rids = []
        for i, r in enumerate(reqs):
            res = out[i][:r.n] if self.cfg.task == "seg" else out[i]
            self.results[r.rid] = res
            self._lat[bucket].append((t_done - r.t_submit, r.n))
            rids.append(r.rid)
        self._t_last = t_done
        return rids

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        """Per-bucket latency percentiles, sustained throughput (None until
        a completed window has positive width) and plan-cache counters, on
        this rank's clock, with the world size and the mesh shape; from
        ``repro_torch.obs``, ``padding`` (this engine's microbatches, slots
        and padded slots), ``model`` (the model's own counts, ``obs.tally``:
        for InvResMLP blocks ``res_queries`` and ``res_blocks``, for Point
        Transformer ``pt_searches`` and ``pt_blocks``) and ``phases``: the
        median host ms (and on the card device ms) of a microbatch and of
        its plan, point-op, MLP and attention spans, over this engine's
        records the registry holds."""
        buckets = {}
        served, points = 0, 0
        wall = None
        if (self._t_first is not None and self._t_last is not None
                and self._t_last > self._t_first):
            wall = self._t_last - self._t_first
        for b, lat in self._lat.items():
            if not lat:
                continue
            ls = np.asarray([l for l, _ in lat])
            pts = int(sum(n for _, n in lat))
            served += len(ls)
            points += pts
            buckets[b] = {
                "count": len(ls),
                "p50_ms": float(np.percentile(ls, 50) * 1e3),
                "p95_ms": float(np.percentile(ls, 95) * 1e3),
                "p99_ms": float(np.percentile(ls, 99) * 1e3),
                "mean_ms": float(ls.mean() * 1e3),
                "clouds_per_s": len(ls) / wall if wall is not None else None,
                "compile_s": self.compile_s.get(b),
            }
        world = None if self.mesh is None else self.mesh.world
        counts = obs.counters(self._obs)
        return {"impl": self.impl, "device": str(self.device),
                "world_size": 1 if world is None else world.size,
                "mesh": None if self.mesh is None else self.mesh.shape,
                "served": served, "wall_s": wall,
                "clouds_per_s": served / wall if wall is not None else None,
                "mpts_per_s": (points / wall / 1e6
                               if wall is not None else None),
                "buckets": buckets, "plan_cache": self.plans.stats(),
                "padding": {k: counts.pop(k) for k in obs.PADDING},
                "model": counts,
                "phases": obs.phase_medians(self._obs)}
