"""FractalCloud core: Fractal partitioning + Block-Parallel Point Ops."""
from repro_torch.core import bppo, fractal
from repro_torch.core.bppo import (BWNeighbors, BWSamples,
                                   blockwise_ball_query, blockwise_fps,
                                   blockwise_interpolate,
                                   blockwise_interpolation_weights,
                                   blockwise_knn, gather)
from repro_torch.core.fractal import (FRACTAL, KDTREE, OCTREE, STRATEGIES,
                                      UNIFORM, FractalOverflowError,
                                      FractalOverflowWarning,
                                      FractalPartition, check_overflow,
                                      default_depth, leaf_view, max_leaves,
                                      partition, unpermute, window_view)

__all__ = [
    "bppo", "fractal", "FRACTAL", "KDTREE", "OCTREE", "UNIFORM",
    "STRATEGIES", "FractalOverflowError", "FractalOverflowWarning",
    "FractalPartition", "check_overflow", "default_depth", "max_leaves",
    "partition", "unpermute", "leaf_view", "window_view", "BWSamples",
    "BWNeighbors", "blockwise_fps", "blockwise_ball_query", "blockwise_knn",
    "blockwise_interpolate", "blockwise_interpolation_weights", "gather",
]
