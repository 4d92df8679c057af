"""latency_p95_ms: 95th percentile of every request's latency in the
window, due time to logits on the host.  A per-layer reading: run to run
on one host it spreads 17-23 %, more than any bound the benchmark may
hold an end-to-end metric to."""
from perfbench.metrics._shares import percentile_ms


def read(record):
    return percentile_ms(record.get("latency_s"), 95)
