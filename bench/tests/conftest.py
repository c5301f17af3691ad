"""Fixtures of the benchmark's tests: the repository's root and ``src``
on the path, and a copy of the benchmark with small traffic mixes that
the CPU runs in seconds (the port's plain path)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: a small pool: 2 BC-Alpha-like and 2 UCI-like streams of 5 snapshots
SMALL_POOL = {"streams": 2, "snapshots": 5, "avg_nodes": 16, "avg_edges": 16,
              "max_nodes": 40, "max_edges": 32}
SMALL_BUCKET = {"n_pad": 64, "e_pad": 256, "k_max": 32}


def small_copy(dest: Path) -> Path:
    """BENCHMARK.json and bench/ copied to ``dest``, with the cells
    ``<config>.small-b4`` (one run_batched call of all 4 streams) and
    ``<config>.small-b1`` (one stream a call) of a small pool,
    ``gcrn-m2.small-serve`` (the serve driver: one serve_multi call of all 4
    streams, the continuous scheduler), and ``gcrn-m2.serve-tenants``, the
    serve traffic at full size, which is not a cell of BENCHMARK.json yet
    (PERF.md, "Open questions")."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    base = json.loads((ROOT / "bench/traffic/replay-b16.json").read_text())
    for ds in base["pool"]:
        ds.update(SMALL_POOL)
    base["bucket"] = SMALL_BUCKET
    man = json.loads((dest / "BENCHMARK.json").read_text())
    for name, per_call in (("small-b4", 4), ("small-b1", 1)):
        (dest / "bench/traffic" / f"{name}.json").write_text(
            json.dumps(dict(base, streams_per_call=per_call)))
        for cfg in ("gcrn-m2", "evolvegcn"):
            man["workloads"].append({"name": f"{cfg}.{name}", "config": cfg,
                                     "traffic": name, "chips": 1,
                                     "why": "small, for the CPU tests"})
    serve = json.loads((ROOT / "bench/traffic/serve-tenants.json").read_text())
    (dest / "bench/traffic/small-serve.json").write_text(json.dumps(
        dict(serve, pool=base["pool"], bucket=SMALL_BUCKET,
             streams_per_call=4)))
    for name, traffic in (("gcrn-m2.small-serve", "small-serve"),
                          ("gcrn-m2.serve-tenants", "serve-tenants")):
        man["workloads"].append({"name": name, "config": "gcrn-m2",
                                 "traffic": traffic, "chips": 1,
                                 "why": "the serve driver's tests"})
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


@pytest.fixture
def small_root(tmp_path) -> Path:
    return small_copy(tmp_path)
