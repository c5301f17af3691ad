#!/usr/bin/env python3
"""The control, and the readings a cell's limits are set from, many seeds
in one process: for each seed a short window of the cell's own calls,
then the program's outputs and the plain reference computed in TF32 (the
control), each judged against the float32 reference by the test that
decides ``correct`` (``core.within_limits``).

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--seconds 2] \\
        [--out bench/out/control.jsonl]

One JSON line a seed on standard output, each appended to ``--out``; the
last line gives, per number compared, the largest program reading (the
lower end of its limit) and the smallest control reading (the upper end).
It exits 1 where a control comes out within the limits or a program run
comes out not correct.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=str(ROOT / "bench" / "out" /
                                         "control.jsonl"))
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from bench.harness import core

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lower: dict = {}
    upper: dict = {}
    passed_controls, failed_runs = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = core.run(ROOT, args.workload, seed, args.seconds, False,
                     out_dir=ROOT / "bench" / "out", control=True)
        limits = {k: c["limit"] for k, c in r["checks"].items()}
        # a control that gives no number has failed
        control = {k: c["value"]
                   for k, c in r.get("control_checks", {}).items()}
        control_correct = bool(control) and core.within_limits(
            dict(control, streams_unchecked=0.0), limits)
        if control_correct:
            passed_controls.append(seed)
        if not r["correct"]:
            failed_runs.append(seed)
        line = {"workload": args.workload, "seed": seed,
                "correct": r["correct"], "control_correct": control_correct,
                "program": {k: c["value"] for k, c in r["checks"].items()},
                "control": control}
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in line["control"].items():
            upper[k] = min(upper.get(k, v), v)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "controls_correct": passed_controls,
                      "programs_not_correct": failed_runs}), flush=True)
    return 1 if passed_controls or failed_runs else 0


if __name__ == "__main__":
    sys.exit(main())
