"""mlp_host_ms.serve: median host ms a microbatch of the program's spans of
the MLPs (every sa<i>.mlp, fp<i>.mlp and head)."""
from perfbench.metrics import _program


def read(record):
    return _program.host_ms(_program.snapshot(), "mlp")
