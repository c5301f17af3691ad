"""Finding/rule data model and report plumbing for ``repro_torch.analysis``
(the port's copy of ``repro.analysis.core``, which it may not import).

The analyzer checks the port's hand-written CUDA stream engines and its
Python surface in three pass GROUPS, each a set of RULES:

  "contracts"  kernel-contract passes: every (family, residency,
               buffer_depth, td) sweep point is driven through
               ``ops.stream_steps`` with ``engine.recording_launches`` on
               (launch assembly only, nothing runs) and checked against
               the shared-memory estimate, the in-place state stores and
               the static contract; the paged rings' and EvolveGCN's
               planes' protocol log is replayed: on the CPU its plain
               version, on the card the log the kernel writes
               (analysis/contracts.py);
  "lint"       AST lint over src/repro_torch (analysis/lint.py);
  "drift"      cross-artifact drift: the port's StreamPlan against the
               docs/api.md field table, and its families against
               FAMILY_LEVELS, the CI matrix and the case builders
               (analysis/drift.py).

Findings are plain data (rule id, severity, path, line, message) so the
CLI can render text, stable JSON, or GitHub annotations from the same
report. Suppression: a ``# booster: ignore[rule-id]`` comment on the
finding's line (lint rules only — contract/drift findings have no
meaningful source line to waive).
"""
from __future__ import annotations

import json
import re
import sys
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Iterable, Optional

GROUPS = ("contracts", "lint", "drift")

#: suppression comment: ``# booster: ignore[rule-id]`` (comma-separated
#: ids allowed). Anchored to the finding's own line.
_SUPPRESS_RE = re.compile(r"#\s*booster:\s*ignore\[([a-z0-9_\-, ]+)\]")


@dataclass(frozen=True)
class Rule:
    """One analyzer rule: identity + severity + the rationale the docs
    catalog renders."""

    id: str
    group: str          # one of GROUPS
    severity: str       # "error" | "warning"
    rationale: str


@dataclass(frozen=True)
class Finding:
    """One violation. ``path`` is repo-relative ("" for registry-level
    contract findings with no source anchor); ``line`` is 1-indexed
    (0 when no line applies)."""

    rule: str
    group: str
    severity: str
    path: str
    line: int
    message: str

    def sort_key(self):
        return (GROUPS.index(self.group), self.rule, self.path, self.line,
                self.message)


@dataclass
class Report:
    findings: list = field(default_factory=list)
    suppressed: int = 0
    rules_run: tuple = ()

    def sorted(self) -> list:
        return sorted(self.findings, key=Finding.sort_key)

    def to_json(self) -> str:
        """Stable machine-readable form: sorted findings, no timestamps,
        no absolute paths — byte-identical across runs on the same tree."""
        return json.dumps(
            {"version": 1,
             "rules_run": sorted(self.rules_run),
             "counts": {"findings": len(self.findings),
                        "suppressed": self.suppressed},
             "findings": [asdict(f) for f in self.sorted()]},
            indent=2, sort_keys=True)

    def to_text(self) -> str:
        lines = []
        for f in self.sorted():
            anchor = f"{f.path}:{f.line}: " if f.path else ""
            lines.append(f"{anchor}{f.severity}[{f.rule}] {f.message}")
        lines.append(f"{len(self.findings)} finding(s), "
                     f"{self.suppressed} suppressed, "
                     f"{len(self.rules_run)} rule(s) run")
        return "\n".join(lines)

    def to_github(self) -> str:
        """GitHub workflow-command annotations (``::error file=..``)."""
        out = []
        for f in self.sorted():
            kind = "error" if f.severity == "error" else "warning"
            loc = f"file={f.path},line={f.line}" if f.path else "file=."
            out.append(f"::{kind} {loc}::[{f.rule}] {f.message}")
        return "\n".join(out)


def suppressed_ids(source_line: str) -> frozenset:
    """Rule ids waived by a ``# booster: ignore[...]`` comment on the
    given source line (empty if none)."""
    m = _SUPPRESS_RE.search(source_line)
    if not m:
        return frozenset()
    return frozenset(x.strip() for x in m.group(1).split(",") if x.strip())


def apply_suppressions(findings: Iterable[Finding], root: Path,
                       report: Report) -> list:
    """Drop findings whose source line carries a matching suppression
    comment; count the drops in the report."""
    kept, cache = [], {}
    for f in findings:
        ids = frozenset()
        if f.path and f.line > 0:
            p = root / f.path
            if p not in cache:
                try:
                    cache[p] = p.read_text().splitlines()
                except OSError:
                    cache[p] = []
            lines = cache[p]
            if 0 < f.line <= len(lines):
                ids = suppressed_ids(lines[f.line - 1])
        if f.rule in ids:
            report.suppressed += 1
        else:
            kept.append(f)
    return kept


def repo_root() -> Path:
    """The repo checkout this installed/`PYTHONPATH=src` package lives in
    (…/src/repro_torch/analysis/core.py -> …)."""
    return Path(__file__).resolve().parents[3]


def select_rules(all_rules: dict, spec: Optional[str]) -> frozenset:
    """Resolve a ``--rules`` spec (comma-separated rule ids and/or group
    names; None = everything) to a set of rule ids."""
    if not spec:
        return frozenset(all_rules)
    chosen = set()
    for tok in (t.strip() for t in spec.split(",")):
        if not tok:
            continue
        if tok in GROUPS:
            chosen |= {rid for rid, r in all_rules.items()
                       if r.group == tok}
        elif tok in all_rules:
            chosen.add(tok)
        else:
            print(f"unknown rule or group {tok!r}; known groups: "
                  f"{', '.join(GROUPS)}; known rules: "
                  f"{', '.join(sorted(all_rules))}", file=sys.stderr)
            raise SystemExit(2)  # bad invocation, distinct from findings
    return frozenset(chosen)
