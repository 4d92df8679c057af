"""point_ops_device_ms.seg: median device ms a microbatch (CUDA events at
the span boundaries) of the program's spans of the point ops (every
sa<i>.sample, sa<i>.group and fp<i>.interpolate)."""
from perfbench.metrics import _program


def read(record):
    return _program.device_ms(_program.snapshot(), "point_ops")
