"""The port's DGNN serve engine on the CPU, held against the JAX one.

The same raw COO snapshots (the synthetic UCI stream, and a tiny dataset
for the express lane) go through ``repro.serve.SnapshotServer`` and
``repro_torch.serve.SnapshotServer`` built over sessions that share the
JAX model's parameters (``params_from_jax``). Outputs per snapshot and
final recurrent states agree at the harness's tolerance (3e-4,
tests/harness.py), and the ``ServeStats`` counters — launches, live and
padded slots, promoted chunks, express launches, launches by family — are
equal. The cases mirror tests/test_serve.py and the express cases of
tests/test_temporal.py (round scheduler), plus the padding helpers.

The JAX server runs under ``ops.set_force_ref(True)``: its stream engine
does not build with the installed jax (ROADMAP queue 3); its force-ref
server does. The port runs with ``device="cpu"``, where every kernel
wrapper runs its plain version.
"""
import dataclasses
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.dgnn import DGNN_CONFIGS, GCRN_M2, STATIC_GCN, TGN, UCI
from repro.configs.dgnn import DatasetConfig
from repro.graph import generate_temporal_graph, slice_snapshots
from repro.graph import padding as jpad
from repro.graph.csr import renumber_and_normalize as jrenumber
from repro.kernels import ops as jops
from repro.serve import SnapshotServer as JServer
from repro_torch import api as tapi
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import build_model, run_plan, stack_time
from repro_torch.graph import padding as tpad
from repro_torch.graph.coo import COOSnapshot
from repro_torch.graph.csr import renumber_and_normalize
from repro_torch.params import params_from_jax
from repro_torch.serve import SnapshotServer as TServer

ATOL = 3e-4
TWO_BUCKETS = ((256, 1024, 48), (640, 4096, 64))
COUNTERS = ("launches", "live_snapshots", "padded_snapshots",
            "promoted_chunks", "express_launches", "launches_by_family")


@pytest.fixture(autouse=True)
def jax_oracle():
    jops.set_force_ref(True)
    yield
    jops.set_force_ref(False)


@pytest.fixture(scope="module")
def uci():
    tg, ft = generate_temporal_graph(UCI)
    return tg, ft, slice_snapshots(tg, 1.0)


def _port_cfg(cfg) -> DGNNConfig:
    return DGNNConfig(**dataclasses.asdict(cfg))


def _port_snaps(snaps) -> list:
    return [COOSnapshot(src=s.src, dst=s.dst, edge_feat=s.edge_feat,
                        t_index=s.t_index) for s in snaps]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """A JAX server and the port's, on the same config, plan fields and
    parameters (the JAX model's, from PRNGKey(seed))."""

    def __init__(self, cfg, n_global, ft, seed=0, express=None, **plan_kw):
        self.cfg, self.pcfg = cfg, _port_cfg(cfg)
        jplan = japi.plan(cfg, **plan_kw)
        self.jsess = japi.BoosterSession(cfg, jplan, n_global=n_global,
                                         feat_table=ft)
        self.jparams = self.jsess.model.init(jax.random.PRNGKey(seed))
        self.jsess.params = self.jparams
        self.jsess.reset_state()
        self.tparams = params_from_jax(self.pcfg, _np(self.jparams))
        tplan = tapi.plan(self.pcfg, **plan_kw)
        self.tsess = tapi.BoosterSession(self.pcfg, tplan, n_global=n_global,
                                         feat_table=ft, params=self.tparams,
                                         device="cpu")
        jx = tx = None
        if express is not None:
            jx, tx = express.jsess, express.tsess
        self.jsrv = JServer(session=self.jsess, express=jx)
        self.tsrv = TServer(session=self.tsess, express=tx)

    def states(self, sids):
        mode = self.jsess.plan.level
        return ({sid: self.jsrv.model.init_state(self.jparams, mode=mode)
                 for sid in sids},
                {sid: self.tsrv.model.init_state(self.tparams, mode=mode)
                 for sid in sids})

    def run(self, snaps):
        jst, jouts, jstats = self.jsrv.run(
            self.jparams, self.jsrv.model.init_state(
                self.jparams, mode=self.jsess.plan.level), snaps)
        tst, touts, tstats = self.tsrv.run(
            self.tparams, self.tsrv.model.init_state(
                self.tparams, mode=self.tsess.plan.level), _port_snaps(snaps))
        return (jst, jouts, jstats), (tst, touts, tstats)

    def run_multi(self, streams, **kw):
        jstates, tstates = self.states(sorted(streams))
        j = self.jsrv.run_multi(self.jparams, jstates, streams, **kw)
        tkw = dict(kw)
        if "express_streams" in kw:
            tkw["express_streams"] = {sid: _port_snaps(s) for sid, s
                                      in kw["express_streams"].items()}
        t = self.tsrv.run_multi(self.tparams, tstates,
                                {sid: _port_snaps(s)
                                 for sid, s in streams.items()}, **tkw)
        return j, t


def assert_state_close(port, ref, label=""):
    ref = _np(ref)
    assert set(port) == set(ref), label
    for k in sorted(ref):
        got = port[k] if isinstance(port[k], list) else [port[k]]
        want = ref[k] if isinstance(ref[k], list) else [ref[k]]
        assert len(got) == len(want), label
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL,
                                       err_msg=f"{label} state {k}[{i}]")


def assert_outs_close(port, ref, label=""):
    assert len(port) == len(ref), label
    for t, (a, b) in enumerate(zip(port, ref)):
        assert isinstance(a, np.ndarray), label
        assert a.shape == b.shape, f"{label} t={t}"
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{label} t={t}")


def assert_counters_equal(port, ref):
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name


def assert_serve_equal(j, t, label=""):
    (jst, jouts, jstats), (tst, touts, tstats) = j, t
    assert_counters_equal(tstats, jstats)
    if isinstance(jouts, dict):
        assert set(touts) == set(jouts)
        for sid in jouts:
            assert_outs_close(touts[sid], jouts[sid], f"{label} {sid}")
            if sid in jst:
                assert_state_close(tst[sid], jst[sid], f"{label} {sid}")
    else:
        assert_outs_close(touts, jouts, label)
        assert_state_close(tst, jst, label)


def _no_serve_threads():
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("dgnn-serve")]
    assert not leaked, leaked


# -------------------------------------------------- single streams ----

def test_serve_v2_single_stream_matches_jax(uci):
    """test_snapshot_server_matches_offline: a v2 stream, per-snapshot
    launches, one fixed bucket."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v2")
    j, t = pair.run(snaps[:6])
    assert_serve_equal(j, t, "v2")
    stats = t[2]
    assert stats.mean_latency_ms > 0 and len(stats.preprocess_ms) == 6
    assert stats.launches == 0  # per-step levels count no stream launch
    _no_serve_threads()


@pytest.mark.parametrize("name,n_snaps", [("gcrn-m2", 6), ("evolvegcn", 7),
                                          ("stacked-gcn-gru", 6)])
def test_serve_v3_single_stream_matches_jax_and_offline(uci, name, n_snaps):
    """test_snapshot_server_v3_stream_matches_offline and the EvolveGCN
    stream-path case: chunks of 4 (6 -> 4 + a tail of 2; 7 -> 4 + 3 padded
    to 4), every chunk one stream-engine launch, no per-snapshot fallback;
    outputs and final state equal the offline v3 run of the same padded
    snapshots."""
    tg, ft, snaps = uci
    cfg = DGNN_CONFIGS[name]
    pair = Pair(cfg, tg.n_global_nodes, ft, level="v3", stream_chunk=4)

    def boom(*a, **k):
        raise AssertionError("per-snapshot fallback taken at v3")

    pair.tsrv._step = boom
    j, t = pair.run(snaps[:n_snaps])
    assert_serve_equal(j, t, name)
    assert t[2].launches == 2
    assert t[2].launches_by_family == {pair.tsrv.model.stream_family: 2}
    # offline: the port's own v3 executor over the same padded stream
    pcfg = pair.pcfg
    model = build_model(pcfg, n_global=tg.n_global_nodes)
    pads = [tpad.pad_snapshot(renumber_and_normalize(s), ft, 640, 4096, 64)
            for s in _port_snaps(snaps[:n_snaps])]
    st0 = model.init_state(pair.tparams, mode="v3")
    off_state, off = run_plan(model, pair.tparams, st0,
                              stack_time(pads).to("cpu"),
                              tapi.plan(pcfg, level="v3"))
    for a, b in zip(t[1], off.numpy()):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for k in off_state:
        got = t[0][k] if isinstance(t[0][k], list) else [t[0][k]]
        want = off_state[k] if isinstance(off_state[k], list) \
            else [off_state[k]]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_serve_hbm_paged_plan_matches_resident_and_jax(uci):
    """Where the plan pages, the server launches the paged engine: the
    same outputs and states as the resident plan and the JAX server."""
    tg, ft, snaps = uci
    kw = dict(level="v3", stream_chunk=4, state_residency="hbm_paged",
              td=16, buffer_depth=2)
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, **kw)
    j, t = pair.run(snaps[:6])
    assert_serve_equal(j, t, "paged")
    resident = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3",
                    stream_chunk=4)
    _, (rst, routs, _) = resident.run(snaps[:6])
    for a, b in zip(t[1], routs):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for k in ("h", "c"):
        np.testing.assert_allclose(t[0][k].numpy(), rst[k].numpy(),
                                   atol=1e-6, rtol=0)


def test_serve_spans_two_buckets(uci):
    """test_snapshot_server_spans_two_buckets: a v2 stream whose snapshots
    land in both buckets; outputs shaped per bucket."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v2",
                buckets=TWO_BUCKETS)
    j, t = pair.run(snaps[:8])
    assert_serve_equal(j, t, "two buckets")
    assert {o.shape[0] for o in t[1]} == {256, 640}


def test_serve_v3_two_buckets_flushes_on_a_bucket_change(uci):
    """At v3 a bucket change flushes the chunk: the same launches and
    padded slots as the JAX server."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4,
                buckets=TWO_BUCKETS)
    j, t = pair.run(snaps[:8])
    assert_serve_equal(j, t, "v3 two buckets")
    assert t[2].launches > 2


@pytest.mark.parametrize("multi", [False, True])
def test_serve_no_bucket_fits_raises(uci, multi):
    """test_snapshot_server_no_fit_bucket_raises and
    test_run_multi_producer_exception_propagates: the producer's error
    reaches the caller (no hang), and no producer thread is left."""
    tg, ft, snaps = uci
    level = "v3" if multi else "v2"
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level=level,
                buckets=((8, 8, 2),))
    if multi:
        streams = {"ok": snaps[:3], "bad": snaps[3:6]}
        with pytest.raises(ValueError, match="no bucket fits"):
            pair.run_multi(streams)
        jstates, tstates = pair.states(streams)
        with pytest.raises(ValueError, match="no bucket fits"):
            pair.tsrv.run_multi(pair.tparams, tstates,
                                {s: _port_snaps(v) for s, v in streams.items()})
    else:
        with pytest.raises(ValueError, match="no bucket fits"):
            pair.jsrv.run(pair.jparams, pair.jsess.state, snaps[:2])
        with pytest.raises(ValueError, match="no bucket fits"):
            pair.tsrv.run(pair.tparams, pair.tsess.state,
                          _port_snaps(snaps[:2]))
    _no_serve_threads()


# ------------------------------------------------------- run_multi ----

def test_run_multi_batched_v3_matches_jax(uci):
    """test_run_multi_batched_v3_matches_per_stream_offline: three tenants
    of uneven lengths in batched v3 launches (dead tail slots and a
    padding row)."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4)
    streams = {"a": snaps[:6], "b": snaps[4:9], "c": snaps[7:10]}
    j, t = pair.run_multi(streams)
    assert_serve_equal(j, t, "multi")
    assert len(t[2].preprocess_ms) == 14
    assert t[2].padded_snapshots > 0


def test_run_multi_same_bucket_streams_share_launch(uci):
    """test_run_multi_bucketed_same_bucket_streams_share_launch."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4,
                buckets=TWO_BUCKETS)
    streams = {"a": snaps[:4], "b": snaps[2:6], "c": snaps[5:9]}
    j, t = pair.run_multi(streams)
    assert_serve_equal(j, t, "same bucket")


def _split_by_bucket(snaps, buckets):
    by = {b: [] for b in buckets}
    for s in snaps:
        ls = jrenumber(s)
        from repro.graph import max_in_degree

        by[jpad.choose_bucket(ls.n_nodes, ls.src.shape[0],
                              max_in_degree(ls), buckets)].append(s)
    return by


@pytest.mark.parametrize("promote,launches,promoted", [
    (None, 2, 0), (1.0, 2, 0), (100.0, 1, 1)])
def test_run_multi_bucket_promotion(uci, promote, launches, promoted):
    """test_run_multi_bucket_promotion_joins_inflight_batch: a generous
    guard promotes the small-bucket chunk into the big bucket's launch, a
    tight one (1.0) or none keeps two launches."""
    tg, ft, snaps = uci
    by = _split_by_bucket(snaps, TWO_BUCKETS)
    streams = {"s": by[TWO_BUCKETS[0]][:4], "b": by[TWO_BUCKETS[1]][:4]}
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4,
                buckets=TWO_BUCKETS, promote_buckets=promote)
    j, t = pair.run_multi(streams)
    assert_serve_equal(j, t, f"promote {promote}")
    assert (t[2].launches, t[2].promoted_chunks) == (launches, promoted)
    assert t[2].live_snapshots == 8


def test_run_multi_measured_guard(uci):
    """test_run_multi_adaptive_promotion_guard_measured: the server times
    one empty chunk a bucket, a positive time each, and a generous ratio
    merges the buckets; the calibration launches count in neither the
    stats nor the fault windows."""
    tg, ft, snaps = uci
    by = _split_by_bucket(snaps, TWO_BUCKETS)
    streams = {"s": by[TWO_BUCKETS[0]][:4], "b": by[TWO_BUCKETS[1]][:4]}
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4,
                buckets=TWO_BUCKETS, promote_buckets=1e6,
                promotion_guard="measured")
    j, t = pair.run_multi(streams)
    assert_serve_equal(j, t, "measured")
    ms = pair.tsrv._bucket_ms
    assert set(ms) == set(TWO_BUCKETS) and all(v > 0 for v in ms.values())
    assert t[2].calibration_fallback is None
    assert (t[2].launches, t[2].promoted_chunks) == (1, 1)
    # the measured costs drive the guard
    ratio = ms[TWO_BUCKETS[1]] / ms[TWO_BUCKETS[0]]
    groups = {TWO_BUCKETS[0]: [("s", ["x"], TWO_BUCKETS[0])],
              TWO_BUCKETS[1]: [("b", ["y"], TWO_BUCKETS[1])]}
    assert set(tpad.promote_bucket_groups(
        groups, TWO_BUCKETS, ratio * 0.5, cost=lambda b: ms[b])) \
        == set(TWO_BUCKETS)
    assert set(tpad.promote_bucket_groups(
        groups, TWO_BUCKETS, ratio * 2.0, cost=lambda b: ms[b])) \
        == {TWO_BUCKETS[1]}


def test_run_multi_evolvegcn_batched_matches_jax(uci):
    """test_run_multi_evolvegcn_takes_batched_stream_path: EvolveGCN joins
    the batched launch (no per-snapshot fallback); the padding slots never
    evolve a tenant's weights."""
    tg, ft, snaps = uci
    pair = Pair(DGNN_CONFIGS["evolvegcn"], tg.n_global_nodes, ft,
                level="v3", stream_chunk=4)

    def boom(*a, **k):
        raise AssertionError("per-snapshot fallback taken at v3")

    pair.tsrv._step = boom
    streams = {"x": snaps[:4], "y": snaps[1:6], "z": snaps[3:6]}
    j, t = pair.run_multi(streams)
    assert_serve_equal(j, t, "evolve multi")
    assert t[2].launches_by_family == {"evolve": t[2].launches}


def test_run_multi_per_step_level_matches_jax(uci):
    """The per-step (non-v3) round loop: round-robin stepping, no stream
    launch."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="o1")
    j, t = pair.run_multi({"a": snaps[:3], "b": snaps[2:4]})
    assert_serve_equal(j, t, "o1 multi")
    assert t[2].launches == 0


def test_static_session_serves_on_the_regular_path(uci):
    """A static-family session served as a regular one: stateless slots,
    no checkpoint, the static engine's launches."""
    tg, ft, snaps = uci
    pair = Pair(STATIC_GCN, tg.n_global_nodes, ft, level="v3",
                stream_chunk=4)
    j, t = pair.run_multi({"a": snaps[:5], "b": snaps[3:6]})
    assert_serve_equal(j, t, "static multi")
    assert t[2].launches_by_family == {"static_gcn": t[2].launches}
    assert t[0] == {"a": {}, "b": {}}


# ----------------------------------------------------- the sessions ----

def test_session_serve_and_serve_multi_match_jax(uci):
    """BoosterSession.serve advances the session state; serve_multi starts
    each tenant from fresh state."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4)
    jouts, jstats = pair.jsess.serve(snaps[:5])
    touts, tstats = pair.tsess.serve(_port_snaps(snaps[:5]))
    assert_outs_close(touts, jouts, "serve")
    assert_counters_equal(tstats, jstats)
    assert_state_close(pair.tsess.state, pair.jsess.state, "serve state")
    streams = {"a": snaps[:3], "b": snaps[1:6]}
    j = pair.jsess.serve_multi(streams)
    t = pair.tsess.serve_multi({s: _port_snaps(v) for s, v in streams.items()})
    assert_serve_equal(j, t, "serve_multi")


def test_session_serve_needs_the_feat_table(uci):
    tg, _, snaps = uci
    pcfg = _port_cfg(GCRN_M2)
    sess = tapi.BoosterSession(pcfg, tapi.plan(pcfg, level="v3"),
                               n_global=tg.n_global_nodes,
                               gen=torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="feat_table"):
        sess.serve(_port_snaps(snaps[:1]))


def test_tgn_session_serve_fails_as_in_jax(uci):
    """A COO snapshot server is not an event-batch server: a tgn session's
    serve fails at its first launch in both packages, with the same
    error (a padded snapshot has no event times)."""
    tg, ft, snaps = uci
    pair = Pair(TGN, tg.n_global_nodes, ft, level="v3")
    with pytest.raises(AttributeError, match="neigh_ts"):
        pair.jsess.serve(snaps[:2])
    with pytest.raises(AttributeError, match="neigh_ts"):
        pair.tsess.serve(_port_snaps(snaps[:2]))
    with pytest.raises(AttributeError, match="neigh_ts"):
        pair.tsess.serve_multi({"a": _port_snaps(snaps[:2])})
    _no_serve_threads()


def test_continuous_scheduler_raises_when_served(uci, monkeypatch):
    """The continuous scheduler is ported (the name is the one this case
    had while it was not): a plan with ``scheduler="continuous"`` and its
    two knobs serves. ``serve`` ignores the fields, as the JAX package's
    does, and equals the round plan's serve bit for bit; ``serve_multi``
    runs ticks, equal to the round scheduler's serve_multi bit for bit and
    within 3e-4 of the JAX continuous server. A sharded DeviceSpec runs
    through the session, bit for bit the unsharded plan, and still raises
    when served."""
    tg, ft, snaps = uci
    streams = {"a": snaps[:5], "b": snaps[3:7]}
    rounds = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3",
                  stream_chunk=2)
    _, (_, solo, _) = rounds.run(snaps[:3])
    _, (r_st, r_outs, _) = rounds.run_multi(streams)
    for kw in (dict(scheduler="continuous"),
               dict(scheduler="continuous", state_pool_pages=1),
               dict(scheduler="continuous", prefill_chunk=1)):
        pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3",
                    stream_chunk=2, **kw)
        _, (_, outs, stats) = pair.run(snaps[:3])
        assert stats.ticks == 0
        assert all(np.array_equal(a, b) for a, b in zip(outs, solo))
        j, t = pair.run_multi(streams)
        (jst, jouts, jstats), (tst, touts, tstats) = j, t
        assert tstats.ticks > 0 and jstats.ticks > 0
        assert tstats.live_snapshots == jstats.live_snapshots
        assert tstats.recoveries == tstats.evictions
        if kw.get("state_pool_pages"):
            assert tstats.evictions > 0
        for sid in streams:
            assert_outs_close(touts[sid], jouts[sid], f"{kw} {sid}")
            assert_state_close(tst[sid], jst[sid], f"{kw} {sid}")
            # the round scheduler on the same plan: equal up to the CPU
            # plain path's batch-dependent last bits (a tick's B and T are
            # not a round's; test_torch_scheduler.py,
            # test_plain_step_bits_on_the_cpu)
            for a, b in zip(touts[sid], r_outs[sid]):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
            for k in r_st[sid]:
                np.testing.assert_allclose(tst[sid][k].numpy(),
                                           r_st[sid][k].numpy(), atol=1e-6,
                                           rtol=0)
        sess = tapi.BoosterSession(
            pair.pcfg, tapi.plan(pair.pcfg, level="v3", **kw),
            n_global=tg.n_global_nodes, feat_table=ft,
            params=pair.tparams, device="cpu")
        _, outs, stats = sess.serve_multi({"a": _port_snaps(snaps[:2])})
        assert len(outs["a"]) == 2 and stats.ticks > 0
    # a sharded plan (plan() refuses a DeviceSpec wider than the host's
    # cards, stubbed to 2): run and run_batched execute it, bit for bit the
    # unsharded plan's; serving it still raises
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    sharded = tapi.plan(rounds.pcfg, level="v3", batch=2,
                        device=tapi.DeviceSpec(n_devices=2))
    sess, plain = (tapi.BoosterSession(
        rounds.pcfg, p, n_global=tg.n_global_nodes, feat_table=ft,
        params=rounds.tparams, device="cpu")
        for p in (sharded, dataclasses.replace(sharded,
                                               device=tapi.DeviceSpec())))
    padded = [stack_time([tpad.pad_snapshot(renumber_and_normalize(s), ft,
                                            640, 4096, 64)
                          for s in _port_snaps(part)])
              for part in (snaps[:2], snaps[2:5])]
    assert torch.equal(sess.run(padded[0]), plain.run(padded[0]))
    # each slice is its own launch: at serve width (640 x 128) the CPU
    # plain path's last bits follow the launch's batch (torch's kernels;
    # test_torch_scheduler.py, test_plain_step_bits_on_the_cpu), so the
    # batched runs agree within 1e-6 here; at the harness widths bit for
    # bit (test_torch_sharding.py)
    (st_s, outs_s), (st_p, outs_p) = (x.run_batched(padded)
                                      for x in (sess, plain))
    for a, b in zip(outs_s + [st_s[k] for k in st_p],
                    outs_p + [st_p[k] for k in st_p]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="does not shard its launches"):
        sess.serve_multi({"a": _port_snaps(snaps[:2])})
    _no_serve_threads()


def test_deprecated_keyword_surface_warns_and_serves(uci):
    """The historical keyword surface builds the equivalent plan and
    session (with a DeprecationWarning); the session surface is silent."""
    tg, ft, snaps = uci
    pcfg = _port_cfg(GCRN_M2)
    with pytest.warns(DeprecationWarning, match="keyword surface"):
        srv = TServer(pcfg, ft, n_global=tg.n_global_nodes, mode="v3",
                      stream_chunk=4, device="cpu")
    assert (srv.plan.level, srv.plan.stream_chunk) == ("v3", 4)
    with pytest.raises(ValueError, match="n_global"):
        with pytest.warns(DeprecationWarning):
            TServer(pcfg, ft, device="cpu")
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4)
    srv.session.params = pair.tparams
    state = srv.model.init_state(pair.tparams, mode="v3")
    _, outs, _ = srv.run(pair.tparams, state, _port_snaps(snaps[:5]))
    _, (_, want, _) = pair.run(snaps[:5])
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        TServer(session=pair.tsess)


# --------------------------------------------------- the express lane ----

_TINY = DatasetConfig("tiny-temporal", avg_nodes=20, avg_edges=40,
                      max_nodes=48, max_edges=192, snapshots=10, seed=3)
_BUCKET = (64, 512, 64)


@pytest.fixture(scope="module")
def tiny():
    tg, ft = generate_temporal_graph(_TINY, feat_dim=8)
    return tg, ft, slice_snapshots(tg, 1.0)


def _mixed(tiny):
    tg, ft, _ = tiny
    gcfg = dataclasses.replace(GCRN_M2, in_dim=8, hidden=16, out_dim=8,
                               edge_dim=8, dataflow="v3")
    scfg = dataclasses.replace(STATIC_GCN, in_dim=8, hidden=16, out_dim=8,
                               edge_dim=8)
    bucket = dict(n_pad=_BUCKET[0], e_pad=_BUCKET[1], k_max=_BUCKET[2])
    express = Pair(scfg, tg.n_global_nodes, ft, seed=1, level="v3", **bucket)
    return express, Pair(gcfg, tg.n_global_nodes, ft, express=express,
                         level="v3", stream_chunk=4, supervision="isolate",
                         **bucket)


def test_serve_express_coexists_with_recurrent(tiny):
    """test_serve_express_coexists_with_recurrent (round scheduler): the
    express tenants' outputs equal the JAX server's and the static model's
    solo forwards; the recurrent tenants' equal serving them alone; the
    launch split shows in the stats."""
    tg, ft, snaps = tiny
    express, pair = _mixed(tiny)
    streams = {"a": snaps[:6], "b": snaps[2:9]}
    xstreams = {"x1": snaps[:5], "x2": snaps[1:8]}
    jstates, tstates = pair.states(sorted(streams))
    j = pair.jsrv.run_multi(pair.jparams, jstates, streams,
                            express_streams=xstreams,
                            express_params=express.jparams)
    t = pair.tsrv.run_multi(pair.tparams, tstates,
                            {s: _port_snaps(v) for s, v in streams.items()},
                            express_streams={s: _port_snaps(v) for s, v
                                             in xstreams.items()},
                            express_params=express.tparams)
    assert_serve_equal(j, t, "express")
    stats = t[2]
    assert stats.express_launches > 0
    assert (stats.launches_by_family.get("static_gcn", 0)
            == stats.express_launches)
    assert stats.launches_by_family.get("gcrn", 0) > 0
    assert stats.launches == sum(stats.launches_by_family.values())
    smodel = express.tsess.model
    for sid, ss in xstreams.items():
        for o, s in zip(t[1][sid], _port_snaps(ss)):
            ps = tpad.pad_snapshot(renumber_and_normalize(s), ft, *_BUCKET)
            _, want = smodel.step(express.tparams, {}, ps.to("cpu"))
            np.testing.assert_allclose(o, want.numpy(), atol=1e-5)
    for sid, ss in streams.items():
        st = pair.tsrv.model.init_state(pair.tparams, mode="v3")
        _, solo, _ = pair.tsrv.run(pair.tparams, st, _port_snaps(ss))
        for a, b in zip(t[1][sid], solo):
            np.testing.assert_allclose(a, b, atol=1e-5)
    _no_serve_threads()


def test_express_lane_validation(tiny):
    """test_express_lane_validation: clashing ids, a non-static express
    session, express streams without a lane."""
    tg, ft, snaps = tiny
    express, pair = _mixed(tiny)
    srv = pair.tsrv
    st = {"a": srv.model.init_state(pair.tparams, mode="v3")}
    with pytest.raises(ValueError, match="both streams and express"):
        srv.run_multi(pair.tparams, st, {"a": _port_snaps(snaps[:2])},
                      express_streams={"a": _port_snaps(snaps[:2])},
                      express_params=express.tparams)
    with pytest.raises(ValueError, match="STATIC-temporal"):
        TServer(session=srv.session, express=srv.session)
    no_express = TServer(session=srv.session)
    with pytest.raises(ValueError, match="needs the express lane"):
        no_express.run_multi(pair.tparams, {}, {},
                             express_streams={"x": _port_snaps(snaps[:1])},
                             express_params=express.tparams)
    bucketed = tapi.BoosterSession(
        express.pcfg, tapi.plan(express.pcfg, level="v3",
                                buckets=(_BUCKET,)),
        n_global=tg.n_global_nodes, feat_table=ft, params=express.tparams,
        device="cpu")
    with pytest.raises(ValueError, match="fixed bucket"):
        TServer(session=srv.session, express=bucketed)


# ------------------------------------------------- padding helpers ----

@pytest.mark.parametrize("real,cap", [(1, None), (3, None), (5, 8), (8, 8),
                                      (6, 6), (0, None), (9, 16)])
def test_pow2_target_matches_jax(real, cap):
    assert tpad.pow2_target(real, cap) == jpad.pow2_target(real, cap)


def test_pow2_target_refuses_a_cap_below_real():
    for mod in (jpad, tpad):
        with pytest.raises(ValueError, match="truncate live data"):
            mod.pow2_target(5, cap=4)


def test_bucket_choice_and_cost_match_jax(uci):
    _, _, snaps = uci
    from repro.graph import max_in_degree as jdeg

    buckets = tpad.DEFAULT_BUCKETS
    assert buckets == jpad.DEFAULT_BUCKETS
    dims = []
    for s in snaps[:12]:
        ls = jrenumber(s)
        d = (ls.n_nodes, ls.src.shape[0], jdeg(ls))
        dims.append(d)
        assert tpad.choose_bucket(*d, buckets) == jpad.choose_bucket(
            *d, buckets)
        assert tpad.bucket_cost(tpad.choose_bucket(*d, buckets)) \
            == jpad.bucket_cost(jpad.choose_bucket(*d, buckets))
    for i in range(0, 12, 3):
        assert tpad.choose_bucket_batch(dims[i:i + 3], buckets) \
            == jpad.choose_bucket_batch(dims[i:i + 3], buckets)
    for mod in (jpad, tpad):
        with pytest.raises(ValueError, match="no bucket fits"):
            mod.choose_bucket(10_000, 1, 1, buckets)
        with pytest.raises(ValueError, match="empty chunk"):
            mod.choose_bucket_batch([], buckets)


def test_promote_bucket_groups_guard_and_chain():
    """test_promote_bucket_groups_guard_and_chain, on both packages."""
    buckets = ((64, 256, 8), (128, 512, 16), (640, 4096, 64))
    small, mid, big = buckets
    cost = tpad.bucket_cost
    cases = [
        ({small: [("a", ["s"], small)], mid: [("b", ["m"], mid)]},
         cost(mid) / cost(small)),
        ({small: [("a", ["s"], small)], mid: [("b", ["m"], mid)]}, 1.0),
        ({mid: [("b", ["m"], mid)], big: [("c", ["g"], big)]},
         cost(big) / cost(mid)),
        ({small: [("a", ["s"], small)], mid: [("b", ["m"], mid)],
          big: [("c", ["g"], big)]}, cost(big) / cost(mid)),
    ]
    want_keys = [{mid}, {small, mid}, {big}, {mid, big}]
    for (groups, ratio), keys in zip(cases, want_keys):
        got = tpad.promote_bucket_groups(groups, buckets, ratio)
        assert got == jpad.promote_bucket_groups(groups, buckets, ratio)
        assert set(got) == keys
        assert all(b == k for k, m in got.items() for _, _, b in m)


def test_padding_round_trip_matches_jax(uci):
    """unpad_snapshot inverts pad_snapshot on the live slice, and
    empty_like_padded is an all-padding snapshot of the same bucket, as in
    the JAX package."""
    _, ft, snaps = uci
    s = snaps[3]
    tps = tpad.pad_snapshot(renumber_and_normalize(_port_snaps([s])[0]), ft,
                            320, 1024, 48)
    jps = jpad.pad_snapshot(jrenumber(s), ft, 320, 1024, 48)
    got, want = tpad.unpad_snapshot(tps), jpad.unpad_snapshot(jps)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    e_t, e_j = tpad.empty_like_padded(tps), jpad.empty_like_padded(jps)
    for f in dataclasses.fields(e_t):
        np.testing.assert_array_equal(np.asarray(getattr(e_t, f.name)),
                                      np.asarray(getattr(e_j, f.name)))
    assert (e_t.n_pad, e_t.e_pad, e_t.k_max) == (320, 1024, 48)


@pytest.mark.parametrize("buckets", [None, TWO_BUCKETS])
def test_producer_threads_do_no_torch_work(uci, monkeypatch, buckets):
    """Producer threads do numpy work only (validate, renumber, ELL, pad):
    every torch call that makes, moves or reads back a tensor during a
    serve runs on the device loop's thread, never on a producer."""
    tg, ft, snaps = uci
    pair = Pair(GCRN_M2, tg.n_global_nodes, ft, level="v3", stream_chunk=4,
                buckets=buckets)
    seen = []

    def recorded(fn):
        def call(*a, **k):
            seen.append(threading.current_thread().name)
            return fn(*a, **k)
        return call

    for mod, name in ((torch, "as_tensor"), (torch, "tensor"),
                      (torch, "stack"), (torch, "zeros_like"),
                      (torch.Tensor, "to"), (torch.Tensor, "cpu"),
                      (tpad.PaddedSnapshot, "to")):
        monkeypatch.setattr(mod, name, recorded(getattr(mod, name)))
    states = {sid: pair.tsrv.model.init_state(pair.tparams, mode="v3")
              for sid in ("a", "b")}
    pair.tsrv.run_multi(pair.tparams, states,
                        {"a": _port_snaps(snaps[:5]),
                         "b": _port_snaps(snaps[3:9])})
    assert seen and not [t for t in seen if t.startswith("dgnn-serve")]
