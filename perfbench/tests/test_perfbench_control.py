"""The control -- the reference computed in TF32, the next precision
below the configurations' float32 with TF32 off, put in the program's
place -- reads above each cell's limit, while the program reads under
it.  Here at a tiny size on the CPU, where TF32 is the operands rounded
to its 10 mantissa bits; on the card at the cell's own size."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, TINY_CELLS


def _calibrate(root, cell, *args):
    p = subprocess.run(
        [sys.executable, "perfbench/calibrate.py", "--workload", cell,
         *args], cwd=root, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]


def _limits(root, cell):
    return json.loads((root / "perfbench" / "limits" / f"{cell}.json")
                      .read_text())


def _fails(readings, limits) -> bool:
    """The control has to fail one of a cell's numbers, not each."""
    return any(v > limits[k] for k, v in readings.items())


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_fails_the_limit_the_program_keeps(tiny, cell):
    rows = _calibrate(tiny, cell, "--seconds", "1", "--seeds", "31",
                      "--control-seeds", "31,32,33", "--device", "cpu")
    limits = _limits(tiny, cell)
    program = [r["program"] for r in rows if "program" in r]
    control = [r["control"] for r in rows if "control" in r]
    assert len(program) == 1 and len(control) == 3
    assert not _fails(program[0], limits)
    assert all(_fails(c, limits) for c in control)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [m[2] for m in TINY_CELLS.values()])
def test_control_fails_the_limit_on_the_card(card, cell):
    rows = _calibrate(REPO, cell, "--control-seeds", "41")
    assert _fails(rows[-1]["control"], _limits(REPO, cell))
