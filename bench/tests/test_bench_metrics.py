"""The metric arithmetic: the rate over the whole window, the p95 over
every call, the union of kernel intervals, the trace's window and
breakdown, each metric's reader."""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT
from bench.harness import core, stats, trace


def reader(name):
    return core.load_module(ROOT / "bench/metrics" / f"{name}.py", "metric",
                            name)


def calls(times, live=10):
    """Back-to-back calls of the given durations (s), each returning to
    the host at half its time."""
    out, t = [], 100.0
    for d in times:
        out.append((t, t + d / 2, t + d, live, "session.run", 0))
        t += d + 0.001
    return out


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 801):
        xs = list(rng.random(n))
        for q in (0, 50, 95, 100):
            assert stats.percentile(xs, q) == pytest.approx(
                np.percentile(xs, q))


def test_union_gaps_and_spread():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 8)]
    assert stats.merge(iv) == [(0, 3), (5, 7)]
    assert stats.union_length(iv) == 5
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (7, 10)]
    assert stats.gaps(iv, 1, 6) == [(3, 5)]
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_rate_is_all_live_snapshots_over_the_whole_window():
    c = calls([0.01] * 9 + [0.05])
    ctx = SimpleNamespace(calls=c, live=sum(x[3] for x in c),
                          window_s=c[-1][2] - c[0][0])
    # 10 calls of 10 live snapshots over 0.14 s of calls and 9 gaps
    assert reader("snapshots_per_s").read(ctx) == pytest.approx(
        100 / (0.14 + 9 * 0.001))


def test_p95_is_over_every_call():
    times = [0.010] * 90 + [0.020] * 10
    ctx = SimpleNamespace(calls=calls(times))
    want = 1e3 * np.percentile(times, 95)
    assert reader("stream_ms_p95").read(ctx) == pytest.approx(want)
    assert reader("session_host_ms").read(ctx) == pytest.approx(
        1e3 * np.mean(times) / 2)


def trace_ctx(ops, window=(0.0, 1.0), n_calls=4, peaks=None, totals=None):
    busy = stats.union_length([(s, e) for _, _, s, e in ops])
    info = trace.TraceInfo(ops, window[0], window[1], busy,
                           window[1] - window[0])
    return SimpleNamespace(
        trace=info, calls=calls([0.2] * n_calls), peaks=peaks,
        totals=totals, window_s=1.0,
        config={"engine": {"kernel": "gcrn_engine_kernel"}})


def test_idle_share_counts_overlaps_once():
    ops = [("void gcrn_engine_kernel<false, false>", "kernel", 0.1, 0.5),
           ("copy", "gpu_memcpy", 0.4, 0.6), ("fill", "kernel", 0.8, 0.9)]
    ctx = trace_ctx(ops)
    assert reader("device_idle_share").read(ctx) == pytest.approx(40.0)
    assert reader("kernels_per_call").read(ctx) == pytest.approx(3 / 4)


def test_roofline_and_mfu_from_the_count():
    peaks = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e11}
    ops = [("void gcrn_engine_kernel<false, false>", "kernel", 0.1, 0.3),
           ("void gcrn_engine_kernel<false, false>", "kernel", 0.5, 0.7),
           ("other", "kernel", 0.7, 0.9)]
    # compute bound 0.1 s, memory bound 0.02 s; engine time 0.4 s
    ctx = trace_ctx(ops, peaks=peaks, totals={
        "engine_flops": 1e11, "engine_bytes": 2e9, "step_flops": 3e11})
    assert reader("engine_roofline").read(ctx) == pytest.approx(25.0)
    assert reader("mfu").read(ctx) == pytest.approx(30.0)
    ctx.peaks = None
    assert reader("engine_roofline").read(ctx) is None
    assert reader("mfu").read(ctx) is None


def test_trace_window_and_breakdown(tmp_path):
    # device clock in us, 1000 us ahead of the host's: markers at 1000
    # and 1900, kernels between them
    ev = [{"ph": "X", "cat": "kernel", "name": "spin_kernel(long)",
           "ts": 1000.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "gcrn_engine_kernel",
           "ts": 1100.0, "dur": 300.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 1500.0, "dur": 50.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 1200.0, "dur": 5.0},
          {"ph": "X", "cat": "kernel", "name": "spin_kernel(long)",
           "ts": 1900.0, "dur": 10.0}]
    tail = dict(ev[-1], ts=1950.0)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev + [tail]}))
    info = trace.window_ops(trace.device_events(path), [0.0], 0.0)
    assert [o[0] for o in info.ops] == ["gcrn_engine_kernel", "Memcpy DtoH"]
    assert info.window_s == pytest.approx(890e-6)
    assert info.busy_s == pytest.approx(350e-6)
    host = [(0.0, 150e-6, 420e-6, 1, "session.run", 0),
            (430e-6, 800e-6, 900e-6, 1, "session.run", 0)]
    bd = trace.breakdown(info, host)
    assert bd["device_ops"][0] == ["gcrn_engine_kernel", pytest.approx(3e-4)]
    idle = dict(bd["idle_gaps"])
    # gaps 10-100 (session), 400-500 (between: midpoint 450 in call 2's
    # session), 550-900 (call 2's session until 800 by midpoint 725)
    assert sum(idle.values()) == pytest.approx(540e-6)
    assert set(idle) <= {"session.run", "harness.sync",
                         "harness.between_calls"}
    # the end and tail markers lost: the window ends at the host's stop
    lost = trace.device_events(path)[:-2]
    short = trace.window_ops(lost, [0.0], 520e-6)
    assert short.window_s == pytest.approx(510e-6)
    assert [o[0] for o in short.ops] == ["gcrn_engine_kernel"]
    with pytest.raises(RuntimeError, match="marker"):
        trace.window_ops([e for e in lost if "spin" not in e[0]], [0.0], 1.0)


def test_reservoir_keeps_one_item_a_key_uniformly_over_all_offered():
    counts = np.zeros((2, 40), int)
    rng = np.random.default_rng(5)
    for _ in range(4000):
        r = core.Reservoir(rng)
        for i in range(40):
            for key in (0, 1):
                r.offer(key, i)
        assert set(r.kept) == {0, 1}
        for key in (0, 1):
            counts[key, r.kept[key]] += 1
    # 100 expected a cell; the last quarter of the window is kept as often
    # as the first
    assert counts.min() > 55 and counts.max() < 150
    assert abs(counts[:, 30:].sum() - counts[:, :10].sum()) < 200
