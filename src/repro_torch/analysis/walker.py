"""Source-tree walking, pragma handling and suppression accounting.

Counterpart of ``repro.analysis.walker``, over the port's tree
(``src/repro_torch/**/*.py``).  The walker owns what is per file rather
than per rule: parsing each file once into an AST that the rule passes
share, reading ``# repolint: disable=RULE-ID`` pragmas from real comment
tokens (a pragma quoted in a docstring is not a pragma), and applying them
afterwards.  A pragma that suppressed nothing is itself a finding (PRG001),
so a stale justification cannot outlive the code it excused.

``lint_source`` lints a source string under a virtual path, which is how
the tests lint fixtures and mutated copies of live modules.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

from repro_torch.analysis import zones
from repro_torch.analysis.report import Finding

_PRAGMA = re.compile(r"#\s*repolint:\s*disable=([A-Z0-9_,\s]+)")


def _comments(text: str):
    """(line, comment) pairs from real COMMENT tokens."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError):
        return


def repo_root() -> Path:
    """The checkout root (.../src/repro_torch/analysis/walker.py -> ...)."""
    root = Path(__file__).resolve().parents[3]
    return root if (root / "src" / zones.PACKAGE).is_dir() else Path.cwd()


def default_tree(root: Path | None = None):
    """The lint target when no paths are given: the src/repro_torch
    package."""
    root = root or repo_root()
    return sorted((root / "src" / zones.PACKAGE).rglob("*.py"))


@dataclasses.dataclass
class SourceFile:
    """One parsed file plus its pragma table, shared by every rule pass."""

    path: str                  # display path (repo-relative when possible)
    text: str
    tree: ast.AST
    zone: str
    pragmas: dict              # line -> set of rule ids disabled there

    @classmethod
    def parse(cls, text: str, path: str, zone: str | None = None):
        tree = ast.parse(text, filename=path)
        pragmas = {}
        comment_text = []
        for lineno, comment in _comments(text):
            comment_text.append(comment)
            m = _PRAGMA.search(comment)
            if m:
                ids = {r.strip() for r in m.group(1).split(",") if r.strip()}
                pragmas[lineno] = ids
        return cls(path=path, text=text, tree=tree,
                   zone=zone or zones.zone_of(path, "\n".join(comment_text)),
                   pragmas=pragmas)


def _display_path(path: Path, root: Path) -> str:
    try:
        return str(path.resolve().relative_to(root))
    except ValueError:
        return str(path)


def _apply_pragmas(src: SourceFile, findings):
    """Drop findings suppressed on their own line; flag unused pragmas."""
    used = set()                      # (line, rule) pairs that fired
    kept = []
    for f in findings:
        if f.rule in src.pragmas.get(f.line, ()):
            used.add((f.line, f.rule))
        else:
            kept.append(f)
    for line, ids in sorted(src.pragmas.items()):
        for rule in sorted(ids):
            if (line, rule) not in used:
                kept.append(Finding(
                    path=src.path, line=line, rule="PRG001",
                    severity=zones.RULE_SEVERITY["PRG001"],
                    message=f"pragma disables {rule} but nothing on this "
                            f"line violates it: remove the stale pragma"))
    return kept


def lint_source(text: str, path: str, zone: str | None = None,
                only: frozenset | None = None):
    """Lint one source string; returns the findings left after pragmas."""
    from repro_torch.analysis import rules  # rules imports walker types

    src = SourceFile.parse(text, path, zone=zone)
    active = zones.rules_for(src.zone)
    if only is not None:
        active &= only
    return _apply_pragmas(src, rules.run_rules(src, active))


def lint_paths(paths, root: Path | None = None,
               only: frozenset | None = None):
    """Lint a list of files; returns the findings across all of them."""
    root = root or repo_root()
    findings = []
    for p in paths:
        p = Path(p)
        findings.extend(lint_source(p.read_text(), _display_path(p, root),
                                    only=only))
    return findings


def lint_tree(root: Path | None = None, only: frozenset | None = None):
    """Lint the whole src/repro_torch package."""
    root = root or repo_root()
    return lint_paths(default_tree(root), root=root, only=only)
