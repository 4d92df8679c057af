"""plan_host_ms.serve: median host ms a microbatch of the program's spans
of the partition plan (stage 0's plan and each later sa<i>.plan)."""
from perfbench.metrics import _program


def read(record):
    return _program.host_ms(_program.snapshot(), "plan")
