"""plan_device_ms.seg: median device ms a microbatch (CUDA events at the
span boundaries) of the program's spans of the partition plan (stage 0's
plan and each later sa<i>.plan)."""
from perfbench.metrics import _program


def read(record):
    return _program.device_ms(_program.snapshot(), "plan")
