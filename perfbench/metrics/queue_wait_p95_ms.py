"""queue_wait_p95_ms: 95th percentile of a request's wait from its due
time to the entry of the step() that served it."""
from perfbench.metrics._shares import percentile_ms


def read(record):
    return percentile_ms(record.get("queue_wait_s"), 95)
