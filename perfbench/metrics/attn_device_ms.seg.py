"""attn_device_ms.seg: median device ms a microbatch (CUDA events at the
span boundaries) of Point Transformer's vector-attention layers, each
block's q/k/v, neighbour gathers, position and weight encodings, softmax,
weighted sum and the BatchNorm after it (pt<l>.enc<j>.attn,
pt<l>.dec.attn); nothing where the program has no such spans."""
import re

from perfbench.metrics import _blocks

ATTN = re.compile(r"pt\d+\.(enc\d+|dec)\.attn")


def read(record):
    return _blocks.device_ms(ATTN)
