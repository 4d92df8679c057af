"""The PNN serving engine on one card: admission -> queue -> plan -> forward.

Counterpart of ``repro.serve.engine`` for one device:

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
  the ``B * ML`` leaf blocks of the microbatch.

The forward reads nothing back to the host.  The one sync of a microbatch
is the copy of its logits to the host; the partition-overflow check runs
after it.  Entry points run on the card (``device=None`` resolves to
``cuda`` and raises where there is none); pass ``device="cpu"`` for the
plain versions.  The engine is synchronous and deterministic: time enters
only through its clock (injectable for tests).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import fractal
from repro_torch.device import resolve_device
from repro_torch.models import pnn
from repro_torch.serve.batching import MicroBatch, MicroBatchQueue
from repro_torch.serve.bucketing import DEFAULT_BUCKETS, BucketPolicy
from repro_torch.serve.plan_cache import PlanCache


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-time knobs (model structure + admission + dispatch)."""

    buckets: tuple = DEFAULT_BUCKETS
    microbatch: int = 4
    max_wait_s: float = 0.02       # deadline for partial microbatches
    variant: str = "pointnet2"     # pointnet2 | pointnext | pointvector
    task: str = "seg"              # cls | seg
    num_classes: int = 6
    th: int = 256                  # fractal threshold (plan-cache key part)
    strategy: str = "fractal"      # partition strategy (plan-cache key part)
    point_ops: str = "bppo"        # bppo | global (global: no plan/dim0)
    leaf_chunk: int | None = None
    stages: tuple | None = None    # override PNNConfig.stages
    fp_widths: tuple | None = None  # override PNNConfig.fp_widths
    on_overflow: str = "warn"      # partition overflow: warn | silent


class ServeEngine:
    """Shape-bucketed, plan-cached PNN serving on one device."""

    def __init__(self, cfg: ServeConfig, params: pnn.PNN | None = None,
                 seed: int = 0, clock=time.monotonic, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # The forward's kernels follow the device: "cuda" launches the
        # hand-written kernels, "plain" runs their PyTorch versions.
        self.impl = "cuda" if self.device.type == "cuda" else "plain"
        self.policy = BucketPolicy(cfg.buckets)
        self.queue = MicroBatchQueue(self.policy, cfg.microbatch,
                                     cfg.max_wait_s)
        self.plans = PlanCache()
        self._clock = clock
        overrides = {k: getattr(cfg, k) for k in ("stages", "fp_widths")
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
        """One microbatch on the device; returns (logits, partition), the
        partition None for the global ops, which have no plan."""
        with torch.inference_mode():
            part = (self._plan_fn(bucket)(clouds, valid, dim0)
                    if self.cfg.point_ops == "bppo" else None)
            out = self._serve_fn(bucket)(self.params, clouds, valid, part)
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
            t0 = time.monotonic()
            clouds = torch.zeros((mb, b, 3), device=self.device)
            valid = torch.zeros((mb, b), dtype=torch.bool, device=self.device)
            dim0 = torch.zeros((mb,), dtype=torch.int64, device=self.device)
            out, _ = self._forward(b, clouds, valid, dim0)
            out.cpu()
            self.compile_s[b] = time.monotonic() - t0
        return dict(self.compile_s)

    def submit(self, coords, now: float | None = None, dim0: int = 0) -> int:
        """Admit one (n, 3) cloud (array or tensor); returns the request
        id.  ``dim0`` phases the cloud's partition plan."""
        now = self._clock() if now is None else now
        coords = torch.as_tensor(np.asarray(coords, dtype=np.float32))
        req = self.queue.submit(coords, now, dim0=dim0)
        if self._t_first is None:
            self._t_first = now
        return req.rid

    def step(self, now: float | None = None) -> list[int]:
        """Dispatch every microbatch ready at ``now`` (full, or past its
        deadline).  Returns the completed request ids; an injected ``now``
        stamps the completions."""
        done = []
        for mb in self.queue.ready(self._clock() if now is None else now):
            done.extend(self._execute(mb, now=now))
        return done

    def flush(self, now: float | None = None) -> list[int]:
        """Drain the queue (end of stream), deadline or not."""
        done = []
        for mb in self.queue.drain():
            done.extend(self._execute(mb, now=now))
        return done

    def take(self, rid: int, default=None):
        """Pop a completed result."""
        return self.results.pop(rid, default)

    def _execute(self, mb: MicroBatch, now: float | None = None) -> list[int]:
        """Run one microbatch.  With an injected ``now`` completions are
        stamped with it; otherwise the engine clock is read after the
        logits reach the host."""
        bucket, reqs = mb.bucket, mb.requests
        npad = self.queue.microbatch - len(reqs)
        clouds = torch.stack([r.coords for r in reqs]
                             + [torch.zeros((bucket, 3))] * npad)
        valid = torch.stack([r.valid for r in reqs]
                            + [torch.zeros((bucket,), dtype=torch.bool)]
                            * npad)
        dim0 = torch.tensor([r.dim0 for r in reqs] + [0] * npad)
        out, part = self._forward(bucket, clouds.to(self.device),
                                  valid.to(self.device),
                                  dim0.to(self.device))
        out = out.cpu().numpy()           # the microbatch's one sync
        t_done = self._clock() if now is None else now
        if part is not None and self.cfg.on_overflow == "warn":
            fractal.warn_if_overflowed(
                part, th=self.cfg.th,
                depth=fractal.default_depth(bucket, self.cfg.th))
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
        a completed window has positive width) and plan-cache counters."""
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
        return {"impl": self.impl, "device": str(self.device),
                "served": served, "wall_s": wall,
                "clouds_per_s": served / wall if wall is not None else None,
                "mpts_per_s": (points / wall / 1e6
                               if wall is not None else None),
                "buckets": buckets, "plan_cache": self.plans.stats()}
