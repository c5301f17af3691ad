"""CLI entry point: ``python -m repro_torch.analysis``.

Exit status: 0 = clean, 1 = findings, 2 = bad invocation. Runs on the
card unless ``--device cpu`` is given (without a card the default raises
``no CUDA device``, as every entry point of the port does). Under GitHub
Actions (``GITHUB_ACTIONS=true``) annotations are emitted alongside the
chosen format so findings land on the PR diff.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from repro_torch.analysis import ALL_RULES, run_all, select_rules
from repro_torch.analysis.core import GROUPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract checker + AST linter for the port's "
                    "CUDA stream engines, plan surface, and serve layer")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text", help="report format (default: text)")
    ap.add_argument("--rules", default=None, metavar="SPEC",
                    help="comma-separated rule ids and/or group names "
                         f"({', '.join(GROUPS)}); default: everything")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="repo root to analyze (default: autodetected)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the contract pass reads the kernels: the "
                         "card (their protocol logs and libraries; the "
                         "default) or the CPU (their plain versions)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(ALL_RULES):
            r = ALL_RULES[rid]
            print(f"{rid:28s} {r.group:9s} {r.severity:7s} {r.rationale}")
        return 0

    rules = select_rules(ALL_RULES, args.rules)
    root = Path(args.root) if args.root else None
    report = run_all(root=root, rules=rules, device=args.device)

    if args.format == "json":
        print(report.to_json())
    elif args.format == "github":
        print(report.to_github() or "analysis clean")
    else:
        print(report.to_text())
    if (os.environ.get("GITHUB_ACTIONS") == "true"
            and args.format != "github" and report.findings):
        print(report.to_github(), file=sys.stderr)
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
