"""res_point_ops_device_ms.seg: median device ms a microbatch (CUDA events
at the span boundaries) of the InvResMLP blocks' point ops: each stage's
one neighbour search (sa<i>.res.group) and each block's feature gather
(sa<i>.res<j>.group)."""
from perfbench.metrics import _blocks


def read(record):
    return _blocks.device_ms(_blocks.POINT_OPS)
