"""The readers of the port's own spans (``repro_torch.obs``):
``host_syncs_per_call``, ``sync_wait_ms``, ``idle_after_sync_ms`` and
``idle_host_issue_ms``, on hand-made spans and device operations. Spans
outside the window are ignored; an idle gap right after a ``sync`` counts
under ``idle_after_sync_ms`` and not under ``idle_host_issue_ms``; with no
span, no ``obs`` module or dropped spans each reader returns None. The
test marked ``cuda`` runs each cell's traced window on the card and holds
the syncs of every call to the count PERF.md derives from the code."""
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from bench.harness import core, port_spans, stats, trace
import repro_torch
from repro_torch import obs

METRICS = ("host_syncs_per_call", "sync_wait_ms", "idle_after_sync_ms",
           "idle_host_issue_ms")
#: syncs a call, by cell (PERF.md, "Spans and counters")
SYNCS = {"gcrn-m2.replay-b16": 6, "evolvegcn.replay-b16": 2,
         "gcrn-m2.replay-b1": 4, "evolvegcn.replay-b1": 1}


def reader(name):
    return core.load_module(ROOT / "bench/metrics" / f"{name}.py", "metric",
                            name)


def span(name, start, end, call=1):
    return SimpleNamespace(name=name, start=start, end=end, call=call)


def ctx_of(ops, calls, window=(0.0, 1.0)):
    busy = stats.union_length([(s, e) for _, _, s, e in ops])
    info = trace.TraceInfo(ops, window[0], window[1], busy,
                           window[1] - window[0])
    return SimpleNamespace(trace=info, calls=calls)


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers these spans as the port's record."""
    def install(spans, counters=None):
        monkeypatch.setattr(obs, "spans", lambda: list(spans))
        monkeypatch.setattr(obs, "counters", lambda: dict(counters or {}))
    return install


# two calls, [0.1, 0.5) and [0.5, 0.9): the session span [0.1, 0.4) then
# the benchmark's synchronise, and [0.5, 0.8)
CALLS = [(0.1, 0.4, 0.5, 10, "session.run", 0),
         (0.5, 0.8, 0.9, 10, "session.run", 1)]
SPANS = [
    span("session.run", 0.1, 0.4, 1), span("sync", 0.15, 0.2, 1),
    span("session.run", 0.5, 0.8, 2), span("sync", 0.55, 0.6, 2),
    span("sync", 0.7, 0.72, 2),
    # outside the window: a warm-up call and one after it
    span("session.run", 0.0, 0.09, 0), span("sync", 0.02, 0.05, 0),
    span("sync", 0.92, 0.95, 3),
]
OPS = [("k", "kernel", 0.0, 0.2),     # the first sync waits for it
       ("k", "kernel", 0.25, 0.3),    # 0.2-0.25 idle after that sync
       ("k", "kernel", 0.35, 0.58),   # 0.3-0.35 idle: host issue
       ("k", "kernel", 0.6, 0.75),    # 0.58-0.6 idle in a sync; the third
       ("k", "kernel", 0.78, 1.0)]    # ends under it; 0.75-0.78 host issue


def test_spans_outside_the_window_are_ignored(recorded):
    recorded(SPANS)
    ctx = ctx_of(OPS, CALLS)
    assert reader("host_syncs_per_call").read(ctx) == pytest.approx(1.5)
    assert reader("sync_wait_ms").read(ctx) == pytest.approx(
        1e3 * (0.05 + 0.05 + 0.02) / 2)


def test_idle_right_after_a_sync_is_not_host_issue(recorded):
    recorded(SPANS)
    ctx = ctx_of(OPS, CALLS)
    after = reader("idle_after_sync_ms").read(ctx)
    issue = reader("idle_host_issue_ms").read(ctx)
    assert after == pytest.approx(1e3 * 0.05 / 2)
    assert issue == pytest.approx(1e3 * 0.08 / 2)
    split = port_spans.idle_split(port_spans.window(ctx), ctx.trace)
    assert split["during_sync"] == pytest.approx(0.02)
    # the three parts are the idle inside the session spans
    gaps = port_spans.device_gaps(ctx.trace)
    in_roots = stats.union_length(port_spans.intersect(
        gaps, [(0.1, 0.4), (0.5, 0.8)]))
    assert sum(split.values()) == pytest.approx(in_roots)


def test_idle_after_a_sync_stops_at_the_session_span(recorded):
    # the sync ends at 0.35, the device idles until 0.5, the call at 0.4
    recorded([span("session.run", 0.1, 0.4), span("sync", 0.3, 0.35)])
    ctx = ctx_of([("k", "kernel", 0.0, 0.32), ("k", "kernel", 0.5, 1.0)],
                 [CALLS[0]])
    assert reader("idle_after_sync_ms").read(ctx) == pytest.approx(50.0)
    assert reader("idle_host_issue_ms").read(ctx) == pytest.approx(0.0)


def test_a_gap_that_two_syncs_end_in_counts_once():
    w = port_spans.Window([(0.0, 1.0)], [(0.1, 0.2), (0.3, 0.4)], 1)
    gaps = [(0.15, 0.6)]
    assert port_spans.after_syncs(w, gaps) == [(0.2, 0.6)]


def test_intersect():
    assert port_spans.intersect([(0, 2), (3, 5), (6, 9)],
                                [(1, 4), (4.5, 7)]) == [
        (1, 2), (3, 4), (4.5, 5), (6, 7)]
    assert port_spans.intersect([(0, 1)], []) == []


@pytest.mark.parametrize("name", METRICS)
def test_no_span_no_reading(name, recorded, monkeypatch):
    ctx = ctx_of(OPS, CALLS)
    recorded([])
    assert reader(name).read(ctx) is None
    # spans only outside the window
    recorded([span("session.run", 0.0, 0.09), span("sync", 0.02, 0.05)])
    assert reader(name).read(ctx) is None
    # dropped spans: the record is not whole
    recorded(SPANS, {"dropped": 1})
    assert reader(name).read(ctx) is None
    # a program without repro_torch.obs
    recorded(SPANS)
    assert reader(name).read(ctx) is not None
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert reader(name).read(ctx) is None
    # no call in the window
    assert reader(name).read(SimpleNamespace(trace=ctx.trace,
                                             calls=[])) is None


@pytest.mark.parametrize("name", METRICS[2:])
def test_idle_readers_need_the_trace(name, recorded):
    recorded(SPANS)
    assert reader(name).read(SimpleNamespace(trace=None,
                                             calls=CALLS)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SYNCS))
def test_on_the_card_every_call_syncs_as_counted(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engines have no CPU mode")
    obs.reset()
    r = core.run(ROOT, workload, 2 ** 31 + 303, 1.0, True, out_dir=tmp_path)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(METRICS) <= set(m), sorted(m)
    assert m["host_syncs_per_call"] == SYNCS[workload]
    roots = {s.call for s in obs.spans() if s.name in port_spans.ROOTS}
    per_call = {c: 0 for c in roots}
    for s in obs.spans():
        if s.name == "sync":
            per_call[s.call] += 1
    assert set(per_call.values()) == {SYNCS[workload]}
    assert m["sync_wait_ms"] <= m["session_host_ms"]


def test_idle_by_innermost_span():
    def s(name, start, end, id, call=1, **attrs):
        return SimpleNamespace(name=name, start=start, end=end, id=id,
                               call=call, attrs=attrs)

    spans = [s("session.run", 0.1, 0.4, 1), s("pack", 0.12, 0.3, 2),
             s("check", 0.14, 0.22, 3), s("sync", 0.15, 0.2, 4, site="idx"),
             s("session.run", 0.5, 0.8, 5, call=2)]
    ctx = ctx_of(OPS, CALLS)
    got = port_spans.idle_by_span(spans, CALLS, ctx.trace)
    # gaps in the calls: 0.2-0.25 (check to 0.22, pack to 0.25), 0.3-0.35
    # (the root), 0.58-0.6 and 0.75-0.78 (the second call's root)
    assert got == pytest.approx({"check": 0.02, "pack": 0.03,
                                 "session.run": 0.05 + 0.02 + 0.03})
    spans[3].end = 0.21
    got = port_spans.idle_by_span(spans, CALLS, ctx.trace)
    assert got["sync:idx"] == pytest.approx(0.01)
    assert got["check"] == pytest.approx(0.01)
