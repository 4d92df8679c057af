"""step_mfu.seg: % of the float32 peak in matmul FLOPs of the rooms
segmented in the window."""
from perfbench.metrics._shares import mfu


def read(record):
    return mfu(record)
