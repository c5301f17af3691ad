"""The traced window: ``torch.profiler`` recording the device's activity
only (tracing the CPU too inflates the host's wall time), and what the
readers take from its trace.

Marker kernels (``torch.cuda._sleep``, named ``spin_kernel``) are
launched just after a synchronise: one before the window's first call, one
after its last, and one more after that. The device window lies between
the first two, and the first marker's launch on the host clock aligns the
device clock with the benchmark's host spans. The profiler can lose the
last records of a trace (seen once in twelve runs on an H100): the third
marker is there to be lost first, and where the second is lost too the
window ends at the host's stop, aligned the same way.
"""
from __future__ import annotations

import bisect
import json
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from bench.harness import stats

#: trace categories of operations that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 10000
#: a kernel name in the breakdown is cut to this many characters
NAME_CHARS = 160


@dataclass
class TraceInfo:
    """Device operations of the window, times in seconds on the host's
    ``perf_counter`` clock."""

    ops: list          # (name, category, start, end)
    start: float       # the device window, host clock
    end: float
    busy_s: float      # union of the operations' intervals in the window
    window_s: float


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def mark() -> float:
    """Launch a marker kernel after a synchronise; its host launch time."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    return t


def device_events(path: Path) -> list:
    """(name, category, start us, end us) of the trace's device
    operations, in start order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [(e["name"], e["cat"], float(e["ts"]),
            float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(ops, key=lambda e: e[2])


def window_ops(events: list, marks: list, t_stop: float) -> TraceInfo:
    """The operations between the first two markers (or the first marker
    and the host's ``t_stop``), on the host clock."""
    spins = [e for e in events if MARKER in e[0]]
    if not spins:
        raise RuntimeError("the trace holds no marker kernel: the profiler "
                           "saw no device activity")
    first = spins[0]
    offset = first[2] * 1e-6 - marks[0]
    end = spins[1][2] if len(spins) > 1 else (t_stop + offset) * 1e6
    ops = [(n, c, s * 1e-6 - offset, e * 1e-6 - offset)
           for n, c, s, e in events
           if MARKER not in n and s >= first[3] and e <= end]
    lo, hi = first[3] * 1e-6 - offset, end * 1e-6 - offset
    busy = stats.union_length([(s, e) for _, _, s, e in ops])
    return TraceInfo(ops, lo, hi, busy, hi - lo)


def finish(prof, marks: list, t_stop: float, out_dir,
           workload: str) -> TraceInfo:
    """Close the window (``marks`` holds the first marker's launch, the
    end marker and the tail marker are launched here), write the trace to
    ``out_dir`` and read it."""
    marks.append(mark())
    marks.append(mark())
    prof.__exit__(None, None, None)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{workload}.trace.json"
    prof.export_chrome_trace(str(path))
    return window_ops(device_events(path), marks, t_stop)


def host_label(t: float, calls: list, starts: list) -> str:
    """What the benchmark's host was doing at ``t``: inside a call's
    session span, waiting in its synchronise, or between calls
    (``starts``: the calls' start times, in order)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0:
        t0, t1, t2, _, label, _ = calls[i]
        if t < t1:
            return label
        if t < t2:
            return "harness.sync"
    return "harness.between_calls"


def breakdown(info: TraceInfo, calls: list) -> dict:
    """The device operations that took most time (summed by name), and the
    device's idle time by what the host was doing (summed by label), the
    ten largest of each."""
    by_op: dict = {}
    for name, _, s, e in info.ops:
        key = name[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    idle: dict = {}
    starts = [c[0] for c in calls]
    for s, e in stats.gaps([(s, e) for _, _, s, e in info.ops], info.start,
                           info.end):
        label = host_label((s + e) / 2, calls, starts)
        idle[label] = idle.get(label, 0.0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
