"""microbatch_host_ms.serve: median host ms of the program's span
`microbatch` (the engine's run of one microbatch, stacking to results):
the inside twin of service_ms_p50."""
from perfbench.metrics import _program


def read(record):
    return _program.host_ms(_program.snapshot(), "microbatch")
