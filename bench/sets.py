#!/usr/bin/env python3
"""Run one cell several times, one process a run as a check does, and
summarise the spread of each metric.

    python3 bench/sets.py --workload <name> --seeds 11,12,13 \\
        [--seconds 10] [--trace 0] [--out bench/out/sets.jsonl]

Each run's result line (or its exit code and the end of its standard
error) is appended to ``--out`` as one JSON object with the seed, the
run's wall seconds and the check's numbers. The summary gives each
metric's median and spread, the distance between the first and third
quartile (``statistics.quantiles(values, n=4)``) over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.harness.stats import spread  # noqa: E402


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.time()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=1500, check=False)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": res.returncode, "wall_s": time.time() - t0,
           "stderr_tail": res.stderr.splitlines()[-12:]}
    lines = res.stdout.strip().splitlines()
    if res.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def summary(recs: list) -> dict:
    values: dict = {}
    for r in recs:
        for k, m in r.get("result", {}).get("metrics", {}).items():
            values.setdefault(k, []).append(m["value"])
    out = {}
    for k, vs in values.items():
        row = {"n": len(vs), "median": statistics.median(vs)}
        if len(vs) >= 2:
            row["spread"] = spread(vs)
        out[k] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "bench" / "out" /
                                         "sets.jsonl"))
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
            "run_seconds"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    recs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = one_run(args.workload, seed, seconds, args.trace)
        recs.append(rec)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res = rec.get("result", {})
        print(json.dumps({"seed": seed, "rc": rec["rc"],
                          "wall_s": round(rec["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {k: m["value"] for k, m in
                                      res.get("metrics", {}).items()},
                          "checks": {k: c["value"] for k, c in
                                     res.get("checks", {}).items()}}),
              flush=True)
        if rec["rc"] != 0:
            print("\n".join(rec["stderr_tail"]), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(recs)}), flush=True)
    return 0 if all(r["rc"] == 0 for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
