"""idle_share.serve: % of the traced window the device sat idle (stream)."""
from perfbench.metrics._shares import idle_share


def read(record):
    return idle_share(record)
