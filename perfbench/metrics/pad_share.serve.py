"""pad_share.serve: % of the microbatch slots dispatched that held an all-
invalid filler cloud (the engine's padded_slots over slots)."""
from perfbench.metrics import _program


def read(record):
    return _program.pad_share(_program.snapshot())
