#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root. It drives ``repro_torch`` (under ``src/``)
on the CUDA card; without a card, or with fewer than the cell asks for, it
exits non-zero and prints no result. The last line of standard output is
the result's JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from bench.harness import core

    try:
        result = core.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_process=T_PROCESS,
                          out_dir=ROOT / "bench" / "out")
    except core.NoDevice as exc:
        core.log(f"no result: {exc}")
        return 3
    found = core.forbidden_modules()
    if found:
        core.log(f"no result: the run loaded {found}")
        return 4
    for name, c in result["checks"].items():
        core.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
