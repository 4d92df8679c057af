"""repro_torch.dist: gradient codecs (bf16 / stochastic int8) with error
feedback.  The rest of ``repro.dist`` (logical sharding rules, elastic
meshes, the jax compat shims) has no counterpart on one card yet."""
from repro_torch.dist import compression

__all__ = ["compression"]
