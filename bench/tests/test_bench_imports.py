"""No module a run loads, and no import statement under bench/, has jax,
jaxlib, flax or the JAX package repro as its top-level name (compared
whole: repro_torch is the port). And a run without a card, or in a
directory holding only the benchmark's files, prints no result."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from conftest import ROOT
from bench.harness import core

CHECK = r'''
import importlib.util, json, sys
from pathlib import Path
root, small = Path(sys.argv[1]), sys.argv[2]
sys.path[:0] = [str(root / "src"), str(root), str(root / "bench" / "tests")]
spec = importlib.util.spec_from_file_location("bench_run", root / "bench/run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from bench.harness import core
for i, p in enumerate(sorted((root / "bench").rglob("*.py"))):
    s = importlib.util.spec_from_file_location(f"m{i}", p)
    sys.modules[s.name] = importlib.util.module_from_spec(s)
    s.loader.exec_module(sys.modules[s.name])
r = core.run(small, "evolvegcn.small-b4", 1, 0.2, False, device="cpu")
r2 = core.run(small, "gcrn-m2.small-b1", 1, 0.2, False, device="cpu")
r3 = core.run(small, "gcrn-m2.small-serve", 1, 0.2, False, device="cpu")
print(json.dumps([core.forbidden_modules(),
                  r["correct"] and r2["correct"] and r3["correct"],
                  sorted({m.split(".")[0] for m in sys.modules})]))
'''


def test_a_run_loads_no_jax_nor_the_jax_package(small_root):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", CHECK, str(ROOT),
                          str(small_root)], capture_output=True, text=True,
                         env=env, timeout=600, check=True)
    forbidden, ok, tops = __import__("json").loads(
        out.stdout.splitlines()[-1])
    assert forbidden == [] and ok
    assert "repro_torch" in tops and "repro" not in tops


def test_no_import_statement_names_jax_or_the_jax_package():
    for path in sorted((ROOT / "bench").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in core.FORBIDDEN, (path, name)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert core.forbidden_modules() == ["jax"]


def run_cli(cwd: Path, env_path: str):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gcrn-m2.replay-b16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=env_path, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    res = run_cli(ROOT, "")
    assert res.returncode != 0 and res.stdout == ""
    assert "no result" in res.stderr


def test_only_the_benchmarks_files_no_result(small_root):
    # small_root holds BENCHMARK.json and bench/ alone: no src/
    res = run_cli(small_root, "")
    assert res.returncode != 0 and res.stdout == ""
