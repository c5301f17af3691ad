"""Drift passes — cross-artifact consistency of the port that its tests
cannot see.

The port's contract surface is read against artifacts it shares with the
JAX package, which it reads and never edits:

  * ``plan-doc-drift``      the port's ``StreamPlan`` fields <-> the
                            docs/api.md "Plan fields" table (both
                            directions);
  * ``family-levels-drift`` the port's ``api.FAMILY_LEVELS`` keys <->
                            ``ops.stream_families()``;
  * ``ci-matrix-drift``     the ci.yml ``family: [...]`` matrix <-> the
                            port's families;
  * ``harness-case-drift``  the ``family == "..."`` branches of
                            tests/harness.py ``stream_kernel_case`` and of
                            repro_torch/analysis/cases.py ``stream_args``
                            <-> the port's families.

Every artifact path is a parameter so tests can point a pass at a drifted
copy without touching the tree.
"""
from __future__ import annotations

import ast
import re
from dataclasses import fields as dc_fields
from pathlib import Path
from typing import Optional

from repro_torch import api
from repro_torch.analysis.core import Finding, Rule
from repro_torch.kernels import ops

RULES = {r.id: r for r in (
    Rule("plan-doc-drift", "drift", "error",
         "docs/api.md's plan-field table is the user-facing contract of both "
         "packages; a port StreamPlan field missing from it (or a "
         "documented field the port lacks) means the docs lie about the "
         "port's API."),
    Rule("family-levels-drift", "drift", "error",
         "The port's api.FAMILY_LEVELS must key exactly its stream "
         "families — a family without a level ladder cannot be planned, "
         "and a ladder without a family is dead dispatch surface."),
    Rule("ci-matrix-drift", "drift", "error",
         "The CI family matrix must enumerate every family the port "
         "dispatches, or a family ships without per-family CI coverage."),
    Rule("harness-case-drift", "drift", "error",
         "tests/harness.py stream_kernel_case (which the port's "
         "differential tests use) and the port's own fixture module must "
         "both build cases for every family, or sweeps silently skip it."),
)}

#: the api.md table section the plan-field pass parses
PLAN_TABLE_HEADING = "## Plan fields"

_BACKTICK = re.compile(r"`([A-Za-z_][A-Za-z0-9_]*)`")
_CI_MATRIX = re.compile(r"^\s*family:\s*\[([^\]]*)\]", re.M)


def _find(rule: str, path: str, line: int, msg: str) -> Finding:
    r = RULES[rule]
    return Finding(rule, r.group, r.severity, path, line, msg)


def _read(root: Path, rel: str) -> Optional[str]:
    try:
        return (root / rel).read_text()
    except OSError:
        return None


def parse_plan_table(text: str):
    """-> {field_name: 1-indexed line} from the plan-field table: every
    backticked identifier in the FIRST cell of each body row under the
    heading (one row may document several fields, e.g. n_pad/e_pad/k_max)."""
    fields, in_table = {}, False
    for i, line in enumerate(text.splitlines(), start=1):
        if line.startswith(PLAN_TABLE_HEADING):
            in_table = True
            continue
        if not in_table:
            continue
        if line.startswith("#"):        # next section: table is over
            break
        s = line.strip()
        if not s.startswith("|"):
            continue
        first = s.strip("|").split("|", 1)[0]
        if set(first.strip()) <= {"-", ":", " "} or "field" == first.strip():
            continue                    # separator / header row
        for name in _BACKTICK.findall(first):
            fields.setdefault(name, i)
    return fields


def check_plan_docs(root: Path, api_md: str = "docs/api.md",
                    plan_cls=api.StreamPlan) -> list:
    text = _read(root, api_md)
    if text is None:
        return [_find("plan-doc-drift", api_md, 0,
                      f"{api_md} not found — the plan-field table is the "
                      "documented API contract")]
    doc = parse_plan_table(text)
    live = [f.name for f in dc_fields(plan_cls)]
    heading_line = next(
        (i for i, line in enumerate(text.splitlines(), start=1)
         if line.startswith(PLAN_TABLE_HEADING)), 0)
    out = []
    for name in live:
        if name not in doc:
            out.append(_find(
                "plan-doc-drift", api_md, heading_line,
                f"the port's StreamPlan field `{name}` has no row in the "
                f"{PLAN_TABLE_HEADING!r} table"))
    for name, line in sorted(doc.items(), key=lambda kv: kv[1]):
        if name not in live:
            out.append(_find(
                "plan-doc-drift", api_md, line,
                f"documented plan field `{name}` does not exist on the "
                "port's StreamPlan"))
    return out


def _set_drift(rule, path, line, label, got, want):
    out = []
    missing, extra = want - got, got - want
    if missing:
        out.append(_find(rule, path, line,
                         f"{label} is missing the port's families: "
                         f"{sorted(missing)}"))
    if extra:
        out.append(_find(rule, path, line,
                         f"{label} names families the port does not have: "
                         f"{sorted(extra)}"))
    return out


def check_family_levels(families=None, levels=None) -> list:
    families = ops.stream_families() if families is None else families
    levels = api.FAMILY_LEVELS if levels is None else levels
    return _set_drift("family-levels-drift", "src/repro_torch/api.py", 0,
                      "api.FAMILY_LEVELS", set(levels), set(families))


def check_ci_matrix(root: Path, ci_yml: str = ".github/workflows/ci.yml",
                    families=None) -> list:
    families = ops.stream_families() if families is None else families
    text = _read(root, ci_yml)
    if text is None:
        return [_find("ci-matrix-drift", ci_yml, 0,
                      f"{ci_yml} not found — no per-family CI coverage")]
    m = _CI_MATRIX.search(text)
    if not m:
        return [_find("ci-matrix-drift", ci_yml, 0,
                      "no `family: [...]` matrix found in the workflow")]
    line = text[:m.start()].count("\n") + 1
    got = {t.strip() for t in m.group(1).split(",") if t.strip()}
    return _set_drift("ci-matrix-drift", ci_yml, line,
                      "the CI family matrix", got, set(families))


def _case_families(tree: ast.AST, fn_name: str):
    """String constants compared against a name ``family`` inside the
    given builder function (``if family == "gcrn": ...`` branches)."""
    fams, line = set(), 0
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == fn_name:
            line = node.lineno
            for cmp_ in ast.walk(node):
                if (isinstance(cmp_, ast.Compare)
                        and isinstance(cmp_.left, ast.Name)
                        and cmp_.left.id == "family"
                        and len(cmp_.comparators) == 1
                        and isinstance(cmp_.comparators[0], ast.Constant)
                        and isinstance(cmp_.comparators[0].value, str)):
                    fams.add(cmp_.comparators[0].value)
            break
    return fams, line


def check_harness_cases(root: Path, harness_py: str = "tests/harness.py",
                        cases_py: str = "src/repro_torch/analysis/cases.py",
                        families=None) -> list:
    families = ops.stream_families() if families is None else families
    out = []
    for rel, fn in ((harness_py, "stream_kernel_case"),
                    (cases_py, "stream_args")):
        text = _read(root, rel)
        if text is None:
            out.append(_find("harness-case-drift", rel, 0,
                             f"{rel} not found — no case builders to check"))
            continue
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            out.append(_find("harness-case-drift", rel, e.lineno or 0,
                             f"unparseable: {e.msg}"))
            continue
        fams, line = _case_families(tree, fn)
        missing = set(families) - fams
        if missing:
            out.append(_find(
                "harness-case-drift", rel, line,
                f"{fn}() in {rel} has no branch for the port's families "
                f"{sorted(missing)} — sweeps silently skip them"))
    return out


def run_drift(root: Path, families=None,
              rules: Optional[frozenset] = None, **paths) -> list:
    """All four drift passes. ``paths`` forwards per-artifact overrides
    (api_md=, ci_yml=, harness_py=, cases_py=) for tests."""
    findings = []
    findings += check_plan_docs(root, **{k: v for k, v in paths.items()
                                         if k in ("api_md",)})
    findings += check_family_levels(families)
    findings += check_ci_matrix(root, families=families,
                                **{k: v for k, v in paths.items()
                                   if k in ("ci_yml",)})
    findings += check_harness_cases(root, families=families,
                                    **{k: v for k, v in paths.items()
                                       if k in ("harness_py", "cases_py")})
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    return findings
