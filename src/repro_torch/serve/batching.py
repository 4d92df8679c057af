"""Per-bucket microbatching queue with a max-wait deadline.

Counterpart of ``repro.serve.batching``.  Requests are FIFO within their
bucket.  A bucket dispatches when it has a full microbatch, or when its
oldest pending request has waited ``max_wait_s``; the engine pads partial
batches to the fixed microbatch size.  Time enters only through the
``now`` argument, so tests drive the deadlines with a fake clock.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.serve.bucketing import BucketPolicy


@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted cloud, already padded to its bucket."""

    rid: int
    coords: Any        # (bucket, 3) padded coordinates
    valid: Any         # (bucket,) bool, False on the padded tail
    n: int             # real (pre-padding) point count
    bucket: int
    t_submit: float
    dim0: int = 0      # split-dimension phase for the partition plan


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A dispatchable unit: <= ``size`` requests of one bucket."""

    bucket: int
    requests: tuple    # tuple[Request]
    deadline_flush: bool


class MicroBatchQueue:
    """Packs pending requests into fixed-size per-bucket microbatches."""

    def __init__(self, policy: BucketPolicy, microbatch: int,
                 max_wait_s: float):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        self.policy = policy
        self.microbatch = microbatch
        self.max_wait_s = max_wait_s
        self._pending: dict[int, list[Request]] = {
            b: [] for b in policy.buckets}
        self._next_rid = 0

    def submit(self, coords, now: float, valid=None, dim0: int = 0) -> Request:
        """Admit one cloud: bucket-pad it and enqueue."""
        n = coords.shape[-2]
        bucket, coords, valid = self.policy.pad(coords, valid)
        req = Request(rid=self._next_rid, coords=coords, valid=valid, n=n,
                      bucket=bucket, t_submit=now, dim0=int(dim0))
        self._next_rid += 1
        self._pending[bucket].append(req)
        return req

    def pending(self, bucket: int | None = None) -> int:
        if bucket is not None:
            return len(self._pending[bucket])
        return sum(len(v) for v in self._pending.values())

    def pop(self, bucket: int, k: int, deadline: bool) -> MicroBatch:
        """Take the ``k`` oldest requests of ``bucket`` as one microbatch
        (what ``ready`` decided on another rank's queue)."""
        reqs = tuple(self._pending[bucket][:k])
        del self._pending[bucket][:k]
        return MicroBatch(bucket=bucket, requests=reqs,
                          deadline_flush=deadline)

    def ready(self, now: float) -> list[MicroBatch]:
        """Every full batch, plus deadline-expired partial batches."""
        out = []
        for b, reqs in self._pending.items():
            while len(reqs) >= self.microbatch:
                out.append(self.pop(b, self.microbatch, deadline=False))
            if reqs and now - reqs[0].t_submit >= self.max_wait_s:
                out.append(self.pop(b, len(reqs), deadline=True))
        return out

    def drain(self) -> list[MicroBatch]:
        """Flush everything still pending (end of stream)."""
        out = []
        for b, reqs in self._pending.items():
            while reqs:
                k = min(len(reqs), self.microbatch)
                out.append(self.pop(b, k, deadline=k < self.microbatch))
        return out
