"""Faults planted in the program for the length of a process, to show that
the comparison that decides ``correct`` catches each fault a cell can
have (the tests, and ``calibrate.py --fault`` for the readings on the
chip).  Never used by a benchmark run.

* ``answer``: one logit of one cloud altered where it is produced;
* ``half``: half of each microbatch left out, its answers those of the
  other half.
"""
from __future__ import annotations

SERVING = ("answer", "half")


def plant(fault: str) -> None:
    from repro_torch.models import pnn

    if fault not in SERVING:
        raise ValueError(f"no fault {fault!r}")
    plain = pnn.apply

    def broken(params, cfg, coords, **kw):
        out = plain(params, cfg, coords, **kw).clone()
        if fault == "answer":
            out[0, 0, 0] += 1.0
        else:
            half = out.shape[0] // 2
            out[half:] = out[:out.shape[0] - half]
        return out

    pnn.apply = broken
