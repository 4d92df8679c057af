"""point_ops_roofline.seg: % of the BPPO point ops' least time (FPS, ball
query, kNN, in-window gather; bytes or operations of the reference plan's
calls over the H100's peaks) over their kernels' device time."""
from perfbench.metrics._shares import roofline


def read(record):
    return roofline(record, ("fps", "ball_query", "knn", "gather"),
                    "point_ops_least_s")
