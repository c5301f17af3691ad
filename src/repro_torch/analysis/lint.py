"""AST lint over the port (stdlib ``ast``) — the "lint" pass group.

The port's copy of the JAX package's rules that read Python
(``repro/analysis/lint.py``), over its own tree: family-named stream defs
outside the registry module (kernels/ops.py), raw ``mode="vN"`` dispatch
and direct ``stream_steps`` calls in the serve layer and the examples,
broad ``except`` (no allowlist: the serve layer catches
``faults.SUPERVISED``), mutable default arguments, and files that do not
parse. The JAX package's
``single-kernel-body`` and ``jnp-in-kernel-body`` read Pallas kernel
bodies; the port has none (its kernels are CUDA under kernels/csrc), so
they have no counterpart here. The scope is the package and the port's
examples (examples/torch, surface code like the serve layer, as the JAX
lint reads examples/); tests/ and chip_smoke.py stay out of scope: they
drive the kernels directly on purpose.

Every rule is a function ``(relpath, tree, lines) -> [Finding]``. Suppress
a single finding with ``# booster: ignore[rule-id]`` on its line — the
tree carries none.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from repro_torch.analysis.core import Finding, Rule

#: directories scanned by default, relative to the repo root
LINT_ROOTS = ("src/repro_torch", "examples/torch")

#: files where catching ``Exception`` / ``BaseException`` is the point:
#: none in the port
BROAD_EXCEPT_ALLOWLIST = frozenset()

#: the module that dispatches every family's stream engine by name
REGISTRY = "src/repro_torch/kernels/ops.py"

#: the surface code that goes through typed plans
_SERVE_SCOPE = ("examples/torch/", "src/repro_torch/serve/")

#: family-named stream def pattern (the JAX lint's, ``lint.py``) and its
#: oracle exemption (kernels/ref.py ``*_stream*_ref[s]``)
_FAMILY_STREAM = re.compile(
    r"^_?[a-z_]*(gcrn|stacked|evolve|dgnn|tgn|static)[a-z_]*_stream[a-z_]*$")
_REF_SUFFIX = re.compile(r"_refs?$")

RULES = {r.id: r for r in (
    Rule("stream-def-outside-registry", "lint", "error",
         "Families are dispatched by name in kernels/ops.py onto one engine "
         "wrapper each; a family-named stream def elsewhere in the port "
         "resurrects per-family copies (plain oracles named *_stream*_ref "
         "are exempt)."),
    Rule("mode-string-dispatch", "lint", "error",
         "The port's serve layer goes through typed StreamPlans; raw "
         "mode=\"vN\" dataflow dispatch bypasses plan validation."),
    Rule("direct-stream-steps", "lint", "error",
         "Direct ops.stream_steps[_batched] calls bypass plan validation; "
         "surface code uses api.run_arrays / BoosterSession instead."),
    Rule("broad-except", "lint", "error",
         "Bare ``except:`` or ``except (Base)Exception`` hides real bugs "
         "(a kernel's build or launch error among them); the port's "
         "supervised sites catch faults.SUPERVISED, and nothing may catch "
         "everything."),
    Rule("mutable-default-arg", "lint", "error",
         "A mutable default ([] / {} / set()) is shared across calls — "
         "state leaks between launches. Use None (or a tuple) and "
         "construct inside the function."),
    Rule("syntax-error", "lint", "error",
         "A file in the lint scope failed to parse — nothing else can be "
         "checked until it does."),
)}


def _iter_files(root: Path, files=None):
    """Yield (relpath, source) for the lint scope. ``files`` overrides
    discovery (tests inject single-snippet trees)."""
    if files is not None:
        paths = [Path(f) for f in files]
    else:
        paths = []
        for top in LINT_ROOTS:
            base = root / top
            if base.is_dir():
                paths.extend(sorted(base.rglob("*.py")))
    for p in paths:
        p = p if p.is_absolute() else root / p
        if "__pycache__" in p.parts:
            continue
        try:
            yield p.relative_to(root).as_posix(), p.read_text()
        except (OSError, ValueError):
            continue


def _find(rule: str, path: str, node, msg: str) -> Finding:
    r = RULES[rule]
    return Finding(rule, r.group, r.severity, path,
                   getattr(node, "lineno", 0), msg)


# ------------------------------------------------------------------ rules

def _chk_stream_def(path, tree, lines):
    if not path.startswith("src/repro_torch/") or path == REGISTRY:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _FAMILY_STREAM.match(node.name) and not _REF_SUFFIX.search(node.name):
            out.append(_find(
                "stream-def-outside-registry", path, node,
                f"family-named stream def `{node.name}` outside {REGISTRY} "
                "— dispatch the family through ops.stream_steps instead"))
    return out


def _chk_mode_string(path, tree, lines):
    if not path.startswith(_SERVE_SCOPE):
        return []

    def _is_vn(node):
        return (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and re.fullmatch(r"v[0-9]+", node.value))

    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "mode" and _is_vn(kw.value):
                    out.append(_find(
                        "mode-string-dispatch", path, kw.value,
                        f'raw mode="{kw.value.value}" dispatch — build a '
                        "StreamPlan (api.plan) instead"))
        elif isinstance(node, ast.Assign):
            if (any(isinstance(t, ast.Name) and t.id == "mode"
                    for t in node.targets) and _is_vn(node.value)):
                out.append(_find(
                    "mode-string-dispatch", path, node,
                    f'mode = "{node.value.value}" assignment — build a '
                    "StreamPlan (api.plan) instead"))
    return out


def _chk_stream_steps(path, tree, lines):
    if not path.startswith(_SERVE_SCOPE):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else None)
        if name in ("stream_steps", "stream_steps_batched"):
            out.append(_find(
                "direct-stream-steps", path, node,
                f"direct {name}() call outside the plan executors — use "
                "api.run_arrays(plan(...), *arrays)"))
    return out


def _chk_broad_except(path, tree, lines):
    if path in BROAD_EXCEPT_ALLOWLIST:
        return []

    def _broad(expr) -> Optional[str]:
        if expr is None:
            return "bare except:"
        if isinstance(expr, ast.Name) and expr.id in ("Exception",
                                                      "BaseException"):
            return f"except {expr.id}"
        if isinstance(expr, ast.Tuple):
            for e in expr.elts:
                b = _broad(e)
                if b and b != "bare except:":
                    return b
        return None

    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            b = _broad(node.type)
            if b:
                out.append(_find(
                    "broad-except", path, node,
                    f"{b} — catch the specific expected errors (the serve "
                    "layer's: faults.SUPERVISED)"))
    return out


def _chk_mutable_default(path, tree, lines):
    def _mutable(node) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp)):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("list", "dict", "set"))

    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        name = getattr(node, "name", "<lambda>")
        for d in list(node.args.defaults) + [d for d in node.args.kw_defaults
                                             if d is not None]:
            if _mutable(d):
                out.append(_find(
                    "mutable-default-arg", path, d,
                    f"mutable default argument in `{name}` — shared "
                    "across calls; default to None/() instead"))
    return out


CHECKS = (_chk_stream_def, _chk_mode_string, _chk_stream_steps,
          _chk_broad_except, _chk_mutable_default)


def run_lint(root: Path, files=None, rules: Optional[frozenset] = None):
    """Run the lint rules over the port (or an injected file list).
    Returns raw findings — suppression filtering happens in core."""
    findings = []
    for relpath, source in _iter_files(root, files):
        try:
            tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            f = Finding("syntax-error", "lint", "error", relpath,
                        e.lineno or 0, f"unparseable file: {e.msg}")
            if rules is None or f.rule in rules:
                findings.append(f)
            continue
        lines = source.splitlines()
        for chk in CHECKS:
            found = chk(relpath, tree, lines)
            if rules is not None:
                found = [f for f in found if f.rule in rules]
            findings.extend(found)
    return findings
