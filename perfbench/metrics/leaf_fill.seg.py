"""leaf_fill.seg: median % of the stage-0 plan's leaf slots (B x ML x th)
that hold a valid point: the BPPO blocks' useful share."""
from perfbench.metrics import _program


def read(record):
    return _program.leaf_fill(_program.snapshot())
