"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (``--device cpu``); the rest of
a run is driven as the benchmark drives it, with a fault of
``perfbench/faults.py`` planted in the program for the length of the run:
each fault a serving cell can have.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import TINY_CELLS

DRIVER = '''
import runpy, sys
root, fault = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, root + "/src"]
from perfbench import faults
faults.plant(fault)
sys.argv = ["perfbench/run.py"] + sys.argv[3:]
runpy.run_path(root + "/perfbench/run.py", run_name="__main__")
'''


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", ["answer", "half"])
def test_fault_makes_the_run_incorrect(tiny, tmp_path, cell, fault):
    driver = tmp_path / "driver.py"
    driver.write_text(DRIVER)
    p = subprocess.run(
        [sys.executable, str(driver), str(tiny), fault, "--workload", cell,
         "--seed", "21", "--seconds", "1.5", "--trace", "0", "--device",
         "cpu"], cwd=tiny, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["logit_rel_err"]["value"] > \
        res["checks"]["logit_rel_err"]["limit"]
