"""Bucketed, microbatched PNN serving on one card."""
from repro_torch.serve.batching import MicroBatch, MicroBatchQueue, Request
from repro_torch.serve.bucketing import (DEFAULT_BUCKETS, BucketPolicy,
                                         mixed_request_sizes)
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.plan_cache import PlanCache

__all__ = ["MicroBatch", "MicroBatchQueue", "Request", "DEFAULT_BUCKETS",
           "BucketPolicy", "mixed_request_sizes", "ServeConfig",
           "ServeEngine", "PlanCache"]
