"""The port's spans and counters (``repro_torch.obs``) on the session path.

* Off means off: a v3 ``BoosterSession.run`` / ``run_batched`` on the CPU
  records no span while no profiler window is open and ``recording()`` is
  off.
* Under ``recording()``, and under a CPU ``torch.profiler`` window, the
  same calls record the session's span tree: each span's parent, and one
  call id shared by every span of a call.
* ``host_syncs`` counts each place the host would block on a card once a
  call: the launchers assemble their launches on CPU tensors inside
  ``engine.recording_launches()`` (so the index checks run), and
  ``obs.blocks`` is patched to take the CPU for a card. The counts are the
  ones PERF.md derives from the code.
* Spans of two threads do not cross parents; the bound drops spans and
  counts them.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import api, obs
from repro_torch.configs.dgnn import EVOLVEGCN, GCRN_M2
from repro_torch.graph.coo import COOSnapshot
from repro_torch.graph.csr import renumber_and_normalize
from repro_torch.graph.padding import pad_snapshot, stack_streams
from repro_torch.kernels import engine

CFGS = {"gcrn": dataclasses.replace(GCRN_M2, in_dim=8, hidden=16, out_dim=8,
                                    edge_dim=4),
        "evolve": dataclasses.replace(EVOLVEGCN, in_dim=8, hidden=16,
                                      out_dim=8, edge_dim=4)}
N_GLOBAL, N_PAD, E_PAD, K_MAX = 48, 32, 128, 16
LENS = (4, 3, 5)

# each span of one call, as (depth, name) in start order: one stream a
# call, and three ragged streams a run_batched call
TREES = {
    ("gcrn", "run"): [
        (0, "session.run"), (1, "edge_terms"), (1, "pack"), (2, "check"),
        (1, "engine"), (2, "check"), (2, "check"), (2, "check"),
        (2, "launch"), (1, "head")],
    ("gcrn", "run_batched"): [
        (0, "session.run_batched"), (1, "stack_ragged"), (1, "edge_terms"),
        (1, "lengths"), (1, "pack"), (2, "check"), (1, "engine"),
        (2, "check"), (2, "check"), (2, "check"), (2, "launch"),
        (1, "head"), (1, "split")],
    ("evolve", "run"): [
        (0, "session.run"), (1, "edge_terms"), (1, "pack"), (1, "engine"),
        (2, "check"), (2, "launch")],
    ("evolve", "run_batched"): [
        (0, "session.run_batched"), (1, "stack_ragged"), (1, "edge_terms"),
        (1, "lengths"), (1, "pack"), (1, "engine"), (2, "check"),
        (2, "launch"), (1, "split")],
}
# the places a call blocks on a card (PERF.md, "Spans and counters")
SYNCS = {("gcrn", "run"): ["renumber", "idx", "rowg", "eidx"],
         ("gcrn", "run_batched"): ["lengths", "renumber", "idx", "rowg",
                                   "eidx", "lengths"],
         ("evolve", "run"): ["idx"],
         ("evolve", "run_batched"): ["lengths", "idx"]}
CASES = sorted(TREES)


def _stream(rng, T, din=8, de=4):
    feat = rng.standard_normal((N_GLOBAL, din)).astype(np.float32)
    snaps = []
    for t in range(T):
        e = int(rng.integers(6, 20))
        src = rng.integers(0, N_GLOBAL, e)
        dst = rng.integers(0, N_GLOBAL, e)
        ef = rng.standard_normal((e, de)).astype(np.float32)
        ls = renumber_and_normalize(COOSnapshot(src, dst, ef, t))
        snaps.append(pad_snapshot(ls, feat, N_PAD, E_PAD, K_MAX))
    return stack_streams(snaps)


@pytest.fixture(autouse=True)
def fresh_record():
    obs.reset()
    yield
    obs.reset()


def _session(model):
    cfg = CFGS[model]
    return api.BoosterSession(cfg, api.plan(cfg, level="v3"),
                              n_global=N_GLOBAL, gen=torch.Generator()
                              .manual_seed(0), device="cpu")


def _call(model, kind, host_arrays=False):
    """The session and a function making one call of ``kind``; the
    streams are CPU tensors (already where the session runs), or host
    arrays with ``host_arrays``."""
    rng = np.random.default_rng(1)
    streams = [_stream(rng, T) for T in LENS]
    if not host_arrays:
        streams = [s.to("cpu") for s in streams]
    sess = _session(model)
    if kind == "run":
        return lambda: sess.run(streams[0])
    return lambda: sess.run_batched(streams)


def _tree(spans, call):
    mine = sorted((s for s in spans if s.call == call),
                  key=lambda s: (s.start, s.id))
    depth = {}
    for s in mine:
        depth[s.id] = 0 if s.parent is None else depth[s.parent] + 1
    return [(depth[s.id], s.name) for s in mine]


@pytest.mark.parametrize("model,kind", CASES)
def test_off_records_no_span(model, kind):
    run = _call(model, kind)
    run()
    assert obs.spans() == []
    assert obs.counters().get("host_syncs", 0) == 0


def _switch(name):
    if name == "recording":
        return obs.recording()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("switch", ["recording", "profiler"])
@pytest.mark.parametrize("model,kind", CASES)
def test_span_tree_of_a_call(model, kind, switch):
    run = _call(model, kind)
    with engine.recording_launches() as launches, _switch(switch):
        run()
        run()
    assert len(launches) == 2
    spans = obs.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [TREES[model, kind][0][1]] * 2
    assert roots[0].call != roots[1].call
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            parent = by_id[s.parent]
            assert s.call == parent.call
            assert parent.start <= s.start and s.end <= parent.end
    for root in roots:
        assert _tree(spans, root.call) == TREES[model, kind]
    # outside the switch, nothing more is recorded
    run()
    assert len(obs.spans()) == len(spans)


def test_the_plain_path_records_no_check_or_launch():
    # without recording_launches the wrappers run their plain versions
    run = _call("gcrn", "run")
    with obs.recording():
        run()
    assert [n for _, n in _tree(obs.spans(), obs.spans()[0].call)] == [
        "session.run", "edge_terms", "pack", "check", "engine", "head"]


@pytest.fixture
def cpu_is_a_card(monkeypatch):
    """``obs.blocks`` taking the CPU for a card: every sync site counts."""
    monkeypatch.setattr(obs, "blocks", lambda device: device is not None)


@pytest.mark.parametrize("model,kind", CASES)
def test_each_sync_site_counts_once_a_call(model, kind, cpu_is_a_card):
    run = _call(model, kind)
    with engine.recording_launches():
        run()                          # counted, not recorded
        assert obs.counters()["host_syncs"] == len(SYNCS[model, kind])
        with obs.recording():
            run()
            run()
    syncs = [s for s in obs.spans() if s.name == "sync"]
    assert obs.counters()["host_syncs"] == 3 * len(SYNCS[model, kind])
    # with spans on, the sync spans equal the counter's increase
    assert len(syncs) == 2 * len(SYNCS[model, kind])
    by_id = {s.id: s for s in obs.spans()}
    for call in {s.call for s in syncs}:
        mine = sorted((s for s in syncs if s.call == call),
                      key=lambda s: s.start)
        assert [s.attrs["site"] for s in mine] == SYNCS[model, kind]
        # each inside the span of its site: a check, the lengths, the head
        assert {by_id[s.parent].name for s in mine} <= {
            "check", "lengths", "head"}


@pytest.mark.parametrize("kind", ["run", "run_batched"])
def test_host_arrays_add_an_upload_sync(kind, cpu_is_a_card):
    run = _call("evolve", kind, host_arrays=True)
    with engine.recording_launches(), obs.recording():
        run()
    sites = [s.attrs["site"] for s in sorted(obs.spans(),
                                             key=lambda s: s.start)
             if s.name == "sync"]
    assert sites == ["upload"] + SYNCS["evolve", kind]


def test_cpu_tensors_block_nothing():
    cpu = torch.device("cpu")
    assert not obs.blocks(cpu) and not obs.blocks(None)
    assert obs.blocks(torch.device("cuda"))
    with obs.recording():
        with obs.sync(cpu, "x"):
            pass
    assert obs.spans() == [] and obs.counters() == {}


def test_threads_do_not_cross_parents():
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with obs.span("root", tag=tag):
            barrier.wait()
            for _ in range(50):
                with obs.span("child", tag=tag):
                    with obs.span("leaf", tag=tag):
                        pass
            barrier.wait()

    with obs.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = obs.spans()
    by_id = {s.id: s for s in spans}
    assert len(spans) == 2 * 101
    roots = {s.attrs["tag"]: s for s in spans if s.parent is None}
    assert set(roots) == {"a", "b"} and roots["a"].call != roots["b"].call
    for s in spans:
        if s.parent is not None:
            assert by_id[s.parent].attrs["tag"] == s.attrs["tag"]
            assert s.call == roots[s.attrs["tag"]].call


def test_counter_adds_are_not_lost_across_threads():
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [obs.count("n") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert obs.counters()["n"] == 16000


def test_the_bound_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 5)
    with obs.recording():
        for i in range(8):
            with obs.span("s", i=i):
                pass
    assert [s.attrs["i"] for s in obs.spans()] == [0, 1, 2, 3, 4]
    assert obs.counters()["dropped"] == 3
    obs.reset()
    assert obs.spans() == [] and obs.counters() == {}


def test_recording_nests_and_a_span_records_its_exception():
    with obs.recording():
        with obs.recording():
            pass
        with pytest.raises(ValueError):
            with obs.span("outer"):
                raise ValueError("x")
    with obs.span("after"):
        pass
    assert [s.name for s in obs.spans()] == ["outer"]
