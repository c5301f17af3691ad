"""repro_torch.analysis — the port's static contract checker and AST linter
for its CUDA stream engines, plan surface and serve layer.

Run it as ``python -m repro_torch.analysis [--format text|json|github]
[--rules contracts,lint,drift|rule-id,...] [--device cuda|cpu]``; exits
non-zero when any finding survives suppression. The rule catalog, and
what each rule reads on the CPU and on the card, is in
docs/static_analysis_torch.md. The rule ids are the JAX package's
(``repro.analysis``) where the meaning carries over.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from repro_torch.analysis import contracts, drift, lint
from repro_torch.analysis.core import (Finding, Report, Rule,
                                       apply_suppressions, repo_root,
                                       select_rules)
from repro_torch.kernels import ops

__all__ = ["ALL_RULES", "Finding", "Report", "Rule", "run_all", "repo_root",
           "select_rules"]

#: every rule the analyzer knows, across the three pass groups.
ALL_RULES = {**contracts.RULES, **lint.RULES, **drift.RULES}


def run_all(root: Optional[Path] = None, rules: Optional[frozenset] = None,
            device: str = "cuda") -> Report:
    """Run every selected pass group over the repo at ``root`` and return
    the suppression-filtered Report. The contract pass reads the card
    (``device="cuda"``, the default: the kernels' own protocol logs and
    the libraries' shared memory and launches); ``device="cpu"`` reads the
    plain versions. Without a card the default raises."""
    dev = ops.resolve_device(device).type
    root = repo_root() if root is None else Path(root)
    rules = frozenset(ALL_RULES) if rules is None else rules
    report = Report(rules_run=tuple(sorted(rules)))
    findings = []
    if rules & set(lint.RULES):
        findings += lint.run_lint(root, rules=rules)
    if rules & set(contracts.RULES):
        findings += contracts.run_contracts(rules=rules, device=dev)
    if rules & set(drift.RULES):
        findings += drift.run_drift(root, rules=rules)
    report.findings = apply_suppressions(findings, root, report)
    return report
