"""res_mlp_device_ms.seg: median device ms a microbatch (CUDA events at the
span boundaries) of the InvResMLP blocks' layers: each block's local
aggregation, pooling, pointwise pair and residual (sa<i>.res<j>.mlp)."""
from perfbench.metrics import _blocks


def read(record):
    return _blocks.device_ms(_blocks.MLP)
