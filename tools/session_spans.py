#!/usr/bin/env python3
"""What the port's session spans show of a benchmark cell, on one CUDA card.

    python3 tools/session_spans.py idle --workload gcrn-m2.replay-b1 --seed 7 [--seconds 10]
    python3 tools/session_spans.py cost --workload gcrn-m2.replay-b1 --seed 7 [--seconds 40]

``idle`` runs the cell as ``bench/run.py --trace 1`` does (it wraps
``bench.harness.trace.breakdown``, which the run calls with the window's
trace and calls, to keep both) and prints one JSON line: the device's idle
inside the session calls by the innermost port span the host was in, in ms
a call (``bench/harness/port_spans.idle_by_span``); the syncs of each call
(``sync`` spans by call id: the counts seen, and the sites of the first
call); the run's per-layer metrics; and the breakdown's idle under the
session's label, a call.

``cost`` builds the cell's session once and times its calls in blocks of
one pass over the pool, in turns off, on, on, off (on: inside
``repro_torch.obs.recording()``, no profiler), for ``--seconds``: each
call's wall time to its outputs synchronised, and the host's time to the
call's return. It also times one span's entry and exit with recording on
and off. Prints one JSON line with the card's name and power limit.
"""
import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the card the calls run on
DEVICE = "cuda"
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))


def idle(args) -> dict:
    from bench.harness import core, port_spans, trace
    from repro_torch import obs

    kept = {}
    breakdown = trace.breakdown

    def keep(info, calls):
        kept.update(info=info, calls=calls)
        return breakdown(info, calls)

    trace.breakdown = keep
    obs.reset()
    r = core.run(ROOT, args.workload, args.seed, args.seconds, True,
                 device=DEVICE, out_dir=ROOT / "bench" / "out")
    trace.breakdown = breakdown
    calls, info = kept["calls"], kept["info"]
    n = len(calls)
    spans = obs.spans()
    by_span = port_spans.idle_by_span(spans, calls, info)
    lo, hi = calls[0][0], calls[-1][2]
    roots = [s for s in spans if s.name in port_spans.ROOTS
             and lo <= s.start and s.end <= hi]
    syncs = {s.call: [] for s in roots}
    for s in sorted(spans, key=lambda s: s.start):
        if s.name == "sync" and s.call in syncs:
            syncs[s.call].append(s.attrs["site"])
    label = calls[0][4]
    return {
        "workload": args.workload, "seed": args.seed, "calls": n,
        "correct": r["correct"], "card": core.power_limit(),
        "idle_ms_a_call_by_span": {k: 1e3 * v / n for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "idle_ms_a_call_in_session_spans": 1e3 * sum(by_span.values()) / n,
        "breakdown_idle_ms_a_call": {k: 1e3 * v / n for k, v in
                                     r["breakdown"]["idle_gaps"]},
        "breakdown_label": label,
        "syncs_a_call_seen": sorted({len(v) for v in syncs.values()}),
        "sync_sites_first_call": next(iter(syncs.values()), []),
        "counters": obs.counters(),
        "metrics": {k: v["value"] for k, v in r["metrics"].items()},
        "device_busy_s": info.busy_s, "window_s": info.window_s}


def span_us(on: bool, n: int = 200000) -> float:
    from repro_torch import obs

    ctx = obs.recording() if on else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("x", site="s"):
                pass
        t = time.perf_counter() - t0
    obs.reset()
    return 1e6 * t / n


def cost(args) -> dict:
    import torch

    from bench.harness import core, streams
    from repro_torch import obs

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = core.Cell.load(ROOT, args.workload)
    dev = torch.device(DEVICE)
    if dev.type == "cuda":
        from repro_torch.kernels import engine

        engine.build([cell.config["engine"]["source"]])
    traffic, widths = cell.traffic, cell.config["widths"]
    pool = streams.generate_pool(traffic, args.seed, widths["in_dim"],
                                 widths["edge_dim"])
    padded = core.ingest(pool, traffic["bucket"], dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed
                                                  % streams.SEED_MOD)
    params = cell.reference.make_params(widths, gen, dev)
    session = core.make_session(cell, params,
                                max(s.n_global for s in pool), dev)
    calls = [core.make_call(session, padded, g, cell.reference.port_state)[0]
             for g in core.call_groups(traffic, len(pool))]
    for fn in calls:
        fn()
    core._sync(dev)
    obs.reset()
    with obs.recording():
        calls[0]()
    core._sync(dev)
    spans_a_call = len(obs.spans())
    obs.reset()
    wall = {"off": [], "on": []}
    host = {"off": [], "on": []}
    t_end = time.perf_counter() + args.seconds
    while time.perf_counter() < t_end:
        for mode in ("off", "on", "on", "off"):
            rec = obs.recording if mode == "on" else contextlib.nullcontext
            for fn in calls:
                t0 = time.perf_counter()
                with rec():
                    fn()
                t1 = time.perf_counter()
                core._sync(dev)
                wall[mode].append(time.perf_counter() - t0)
                host[mode].append(t1 - t0)
        obs.reset()

    def ms(xs):
        return {"mean": 1e3 * statistics.fmean(xs),
                "median": 1e3 * statistics.median(xs), "n": len(xs)}

    out = {"workload": args.workload, "seed": args.seed,
           "card": core.power_limit(), "spans_a_call": spans_a_call,
           "wall_ms": {k: ms(v) for k, v in wall.items()},
           "host_ms": {k: ms(v) for k, v in host.items()},
           "span_us_on": span_us(True), "span_us_off": span_us(False)}
    out["wall_cost_share"] = (out["wall_ms"]["on"]["mean"]
                              / out["wall_ms"]["off"]["mean"] - 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("idle", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    if args.seconds is None:
        args.seconds = 10.0 if args.mode == "idle" else 40.0
    out = idle(args) if args.mode == "idle" else cost(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
