"""engine_wait_ms_p95.serve: 95th percentile of a request's wait from
submit to the step() that dispatched it, on the engine's clock: the
inside twin of queue_wait_p95_ms."""
from perfbench.metrics import _program


def read(record):
    return _program.engine_wait_ms(_program.snapshot(), 95)
