"""pt_search_device_ms.seg: median device ms a microbatch (CUDA events at
the span boundaries) of Point Transformer's stride-1 kNN searches, one a
level, each mapped to the clouds' order with its offsets (pt<l>.group);
nothing where the program has no such spans."""
import re

from perfbench.metrics import _blocks

SEARCH = re.compile(r"pt\d+\.group")


def read(record):
    return _blocks.device_ms(SEARCH)
