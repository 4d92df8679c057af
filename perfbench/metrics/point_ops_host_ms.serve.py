"""point_ops_host_ms.serve: median host ms a microbatch of the program's
spans of the point ops (every sa<i>.sample, sa<i>.group and
fp<i>.interpolate)."""
from perfbench.metrics import _program


def read(record):
    return _program.host_ms(_program.snapshot(), "point_ops")
