"""The port's own spans of a run's window (``repro_torch.obs``), for the
readers of the session's per-layer metrics.

The port records its spans on ``time.perf_counter``, the clock of the
benchmark's calls and of the device trace (``trace.py``), and only while
a profiler window is open: in a ``--trace 1`` run, the whole window. Only
spans that lie inside the window count, from the first call's start to the
last call's synchronised end. A program without ``repro_torch.obs``, or a
window in which the port recorded no session span (or dropped any), gives
None, and so does each reader.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

from bench.harness import stats

#: the port's root spans: one a session call
ROOTS = ("session.run", "session.run_batched")


@dataclass
class Window:
    """The port's spans of the window, as (start, end) intervals."""

    roots: list     # the session calls' root spans
    syncs: list     # the ``sync`` spans: the host blocked on the card
    calls: int      # the window's completed calls


def window(ctx):
    """The port's spans of the run's window, or None."""
    if not ctx.calls:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if obs.counters().get("dropped"):
        return None
    return of_spans(obs.spans(), ctx.calls)


def of_spans(spans, calls):
    """``Window`` of the spans inside [first call's start, last call's
    end], or None where no root span lies there."""
    lo, hi = calls[0][0], calls[-1][2]
    inside = [s for s in spans if s.start >= lo and s.end <= hi]
    roots = [(s.start, s.end) for s in inside if s.name in ROOTS]
    if not roots:
        return None
    return Window(roots, [(s.start, s.end) for s in inside
                          if s.name == "sync"], len(calls))


def intersect(a, b) -> list:
    """The stretches two sets of (start, end) intervals share."""
    a, b = stats.merge(a), stats.merge(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def device_gaps(trace) -> list:
    """The stretches of the device window in which no operation ran."""
    return stats.gaps([(s, e) for _, _, s, e in trace.ops], trace.start,
                      trace.end)


def after_syncs(w: Window, gaps: list) -> list:
    """For each sync span, the device's idle from the span's end to the
    next device operation (none where an operation runs at its end),
    inside the session's spans."""
    starts = [g[0] for g in gaps]
    out = []
    for _, end in w.syncs:
        i = bisect.bisect_right(starts, end) - 1
        if i >= 0 and gaps[i][1] > end:
            out.append((end, gaps[i][1]))
    return intersect(out, w.roots)


def idle_split(w: Window, trace) -> dict:
    """The device's idle inside the session's spans, in seconds:
    ``during_sync`` (while the host blocked), ``after_sync`` (from a sync's
    end to the next device operation) and ``host_issue`` (the rest: the
    device waiting for the host to issue work)."""
    gaps = device_gaps(trace)
    in_roots = intersect(gaps, w.roots)
    during = intersect(in_roots, w.syncs)
    after = after_syncs(w, gaps)
    waited = stats.union_length(during + after)
    return {"during_sync": stats.union_length(during),
            "after_sync": stats.union_length(after),
            "host_issue": stats.union_length(in_roots) - waited}


def idle_by_span(spans, calls, trace) -> dict:
    """The device's idle inside the session's spans of the window, in
    seconds, by the innermost port span the host was in at the time (a
    ``sync`` by its site: ``sync:<site>``). Spans of one call nest, so the
    innermost one holding a moment is the one that started last."""
    lo, hi = calls[0][0], calls[-1][2]
    inside = [s for s in spans if s.start >= lo and s.end <= hi]
    roots = sorted((s for s in inside if s.name in ROOTS),
                   key=lambda s: s.start)
    by_call: dict = {}
    for s in inside:
        by_call.setdefault(s.call, []).append(s)
    starts = [r.start for r in roots]
    out: dict = {}
    for g0, g1 in intersect(device_gaps(trace),
                            [(r.start, r.end) for r in roots]):
        mine = by_call[roots[bisect.bisect_right(starts, g0) - 1].call]
        cuts = sorted({g0, g1} | {t for s in mine for t in (s.start, s.end)
                                  if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            t = (a + b) / 2
            inner = max((s for s in mine if s.start <= t < s.end),
                        key=lambda s: (s.start, s.id))
            key = (f"sync:{inner.attrs['site']}" if inner.name == "sync"
                   else inner.name)
            out[key] = out.get(key, 0.0) + (b - a)
    return out
