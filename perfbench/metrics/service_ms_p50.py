"""service_ms_p50: median host time of an engine step() that ran a
microbatch."""
from perfbench.metrics._shares import percentile_ms


def read(record):
    return percentile_ms(record.get("service_s"), 50)
