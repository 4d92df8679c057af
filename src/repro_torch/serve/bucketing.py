"""Shape-bucketed admission.

Counterpart of ``repro.serve.bucketing``.  Each cloud is padded up to the
minimal fitting bucket of a small ladder, the tail masked invalid, so the
forward only ever sees one shape per bucket.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels import ops as kops

DEFAULT_BUCKETS = (4096, 16384, 65536)


def mixed_request_sizes(buckets, requests: int, seed: int = 0):
    """A mixed-size request stream: ``n`` drawn uniformly from each
    bucket's full size and ~70% size, so every bucket sees exact fits and
    padded admissions."""
    sizes = sorted({n for b in buckets for n in (b, max(1, int(0.7 * b)))})
    rng = np.random.default_rng(seed)
    return [int(rng.choice(sizes)) for _ in range(requests)]


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """An ascending ladder of admissible cloud sizes."""

    buckets: tuple = DEFAULT_BUCKETS

    def __post_init__(self):
        b = tuple(sorted(set(int(x) for x in self.buckets)))
        if not b or b[0] <= 0:
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        object.__setattr__(self, "buckets", b)

    def select(self, n: int) -> int:
        """Minimal bucket that fits an ``n``-point cloud."""
        if n <= 0:
            raise ValueError(f"need a non-empty cloud, got n={n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"cloud with {n} points exceeds the largest "
                         f"bucket {self.buckets[-1]}")

    def pad(self, coords, valid=None):
        """Admit one ``(p, 3)`` cloud tensor: returns (bucket, coords',
        valid') padded to the selected bucket, the tail masked invalid."""
        bucket = self.select(coords.shape[-2])
        coords, valid = kops.pad_points(coords, bucket, valid)
        return bucket, coords, valid
