"""gap_device_ms.seg: median device ms between consecutive microbatches,
from the end of the logits' copy to the host to the start of the next
clouds' copy to the card (CUDA events)."""
from perfbench.metrics import _program


def read(record):
    return _program.gap_device_ms(_program.snapshot())
