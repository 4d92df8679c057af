"""repro_torch.analysis: the port's contract linter and interface checker.

Counterpart of ``repro.analysis``, over ``src/repro_torch``, with the
reference's rule ids, pragma syntax, finding format and CLI flags:

* **lint layer** (``walker`` + ``rules``): AST passes keyed by module zone
  (``zones``): clock discipline (CLK001-CLK003), cache keys (TRC001),
  every public op classified for its gradient (VJP001), kernel selection
  by device only (DSP001, DSP002).  Findings print as ``file:line RULE-ID
  severity message`` and are suppressible with ``# repolint:
  disable=RULE-ID`` pragmas (an unused pragma is itself a finding,
  PRG001).
* **interface layer** (``abstract``): every public op of
  ``kernels/ops.py`` across a shape ladder x device x chunk matrix,
  against its kernel's plain version (ABS001, ABS002), and every launch of
  the CUDA kernels against the card's limits (ABS003 geometry, ABS004
  shared memory and spills), read from the launchers' own geometry.

Run ``python -m repro_torch.analysis --strict`` on the card, or with
``--device cpu`` here; lint files alone with
``python -m repro_torch.analysis path/to/file.py``.
"""
from repro_torch.analysis.report import ERROR, WARN, Finding  # noqa: F401
from repro_torch.analysis.walker import (lint_paths,  # noqa: F401
                                         lint_source, lint_tree)
from repro_torch.analysis.zones import (RULE_DOC,  # noqa: F401
                                        RULE_SEVERITY, RULE_ZONES, zone_of)

__all__ = ["Finding", "ERROR", "WARN", "lint_source", "lint_paths",
           "lint_tree", "zone_of", "RULE_DOC", "RULE_SEVERITY",
           "RULE_ZONES"]
