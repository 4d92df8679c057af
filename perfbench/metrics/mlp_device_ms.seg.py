"""mlp_device_ms.seg: median device ms a microbatch (CUDA events at the
span boundaries) of the program's spans of the MLPs (every sa<i>.mlp,
fp<i>.mlp and head)."""
from perfbench.metrics import _program


def read(record):
    return _program.device_ms(_program.snapshot(), "mlp")
