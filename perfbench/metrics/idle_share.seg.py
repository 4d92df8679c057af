"""idle_share.seg: % of the traced window the device sat idle (cell rooms)."""
from perfbench.metrics._shares import idle_share


def read(record):
    return idle_share(record)
