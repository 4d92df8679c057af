"""gap_program_share.seg: median % of the host interval between consecutive
microbatches that the program's own spans (finish, admit, stack) cover;
the rest is the caller's."""
from perfbench.metrics import _program


def read(record):
    return _program.gap_program_share(_program.snapshot())
