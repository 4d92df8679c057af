"""Keyed cache of serving callables with build counters.

Counterpart of ``repro.serve.plan_cache``.  Keys are explicit tuples --
``("plan", bucket, th, strategy)`` for the partition plan, ``("serve",
bucket, impl)`` for the forward -- so admission bucketing bounds the
population.  PyTorch runs eagerly: an entry is the plain callable, built
once, and ``traces`` counts builds (one per key), the eager analogue of
one JAX trace per key.
"""
from __future__ import annotations

import collections


class PlanCache:
    """get(key, build) -> callable; build() makes it on the first miss."""

    def __init__(self):
        self._fns: dict = {}
        self.hits = collections.Counter()
        self.misses = collections.Counter()
        self.traces = collections.Counter()

    def get(self, key, build):
        fn = self._fns.get(key)
        if fn is not None:
            self.hits[key] += 1
            return fn
        self.misses[key] += 1
        self.traces[key] += 1
        fn = build()
        self._fns[key] = fn
        return fn

    def __len__(self) -> int:
        return len(self._fns)

    def __contains__(self, key) -> bool:
        return key in self._fns

    def keys(self):
        return self._fns.keys()

    def stats(self) -> dict:
        return {"executables": len(self._fns),
                "hits": sum(self.hits.values()),
                "misses": sum(self.misses.values()),
                "traces": dict(self.traces)}
