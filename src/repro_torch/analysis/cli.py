"""CLI: ``python -m repro_torch.analysis [paths ...] [--strict] [...]``.

Counterpart of ``repro.analysis.cli``.  With no paths it lints the whole
``src/repro_torch`` tree and runs the interface checks (``abstract``);
with explicit paths it lints just those files and skips the interface
checks unless ``--abstract`` is given.  The lint needs no device.  The
interface checks run on the card (``--device`` defaults to it, by the rule
of ``repro_torch.device``) and raise where there is none; ``--device cpu``
runs their CPU part.  Exit code 0 when clean, 1 when findings fail (errors
always; warnings too under ``--strict``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import report, walker, zones


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract linter and interface checker of the "
                    "PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: the src/repro_torch tree)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings fail too (the gate mode)")
    ap.add_argument("--abstract", dest="abstract", action="store_true",
                    default=None, help="force the interface checks on "
                    "(default: on for tree runs, off for explicit paths)")
    ap.add_argument("--no-abstract", dest="abstract", action="store_false",
                    help="skip the interface checks")
    ap.add_argument("--rules", default=None,
                    help="comma list of rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--device", default=None,
                    help="where the interface checks run (default: the "
                    "CUDA card, raising if there is none; 'cpu' runs "
                    "their CPU part)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(zones.RULE_DOC):
            sev = zones.RULE_SEVERITY.get(rule, report.ERROR)
            print(f"{rule}  {sev:5s}  {zones.RULE_DOC[rule]}")
        return 0

    only = (frozenset(r.strip() for r in args.rules.split(","))
            if args.rules else None)
    run_abstract = args.abstract
    if run_abstract is None:
        run_abstract = not args.paths

    if args.paths:
        findings = walker.lint_paths(args.paths, only=only)
    else:
        findings = walker.lint_tree(only=only)
    if run_abstract:
        from repro_torch.analysis import abstract
        from repro_torch.device import resolve_device

        findings += abstract.run_interface_checks(
            device=resolve_device(args.device))

    findings = report.sort_findings(findings)
    for f in findings:
        print(f.format())
    print(report.summarize(findings), file=sys.stderr)
    return 1 if report.failed(findings, strict=args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
