"""Findings: the one record type every analysis layer emits.

Counterpart of ``repro.analysis.report``.  The AST lint rules
(``rules.py``) and the interface checks (``abstract.py``) both report
through this module, so the CLI and the tests see one stream of
``file:line RULE-ID severity message`` lines whichever layer produced
them.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARN = "warn"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location."""

    path: str          # repo-relative where possible
    line: int
    rule: str          # e.g. "CLK001"
    severity: str      # ERROR | WARN
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.severity} " \
               f"{self.message}"


def sort_findings(findings):
    """Stable report order: by file, then line, then rule id."""
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def summarize(findings) -> str:
    errors = sum(1 for f in findings if f.severity == ERROR)
    warns = len(findings) - errors
    if not findings:
        return "repro_torch.analysis: clean"
    return (f"repro_torch.analysis: {len(findings)} finding(s) "
            f"({errors} error(s), {warns} warning(s))")


def failed(findings, strict: bool = False) -> bool:
    """Exit-code policy: errors always fail; warnings fail under --strict."""
    if any(f.severity == ERROR for f in findings):
        return True
    return strict and bool(findings)
