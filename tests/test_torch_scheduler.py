"""The port's continuous scheduler and paged tenant-state pool on the CPU:
tests/test_scheduler.py case for case, on ``repro_torch.serve``.

Each continuous run is held two ways:

  * against the port's own round scheduler on the same plan without the
    continuous fields, bit for bit (outputs and final recurrent states);
  * against the JAX server running the same continuous plan under
    ``ops.set_force_ref(True)`` (its stream engine does not build with the
    installed jax, ROADMAP queue 3), on the same numpy snapshots and the
    JAX model's parameters (``params_from_jax``), at the harness's 3e-4,
    with the counters a run fixes equal.

Tick composition depends on timing (producer threads race the device
loop), so ``ticks``, ``launches``, ``prefill_chunks``, ``evictions`` and
the chunking change from run to run. What a run fixes, and what is held
equal to the JAX server's: outputs and final states, ``live_snapshots``,
``recoveries == evictions``, the length of each tenant's ``commit_ms``, and
the structural facts the JAX tests assert (``ticks > 0``,
``prefill_chunks > 0`` with ``queue_depth`` above the backlog).

Also ported: the continuous cases of tests/test_temporal.py (the express
lane beside recurrent tenants, and the mixed-traffic scale case). What is
the port's own: a committed tenant state owns its storage on both
schedulers; producer threads do no torch work under the continuous
scheduler either; under strict supervision the run's own error propagates
past the end-of-run flush; the new modules are lint-clean; and a broken
kernel is never served by the oracle under ticks.

Left out: ``test_measured_cost_missing_bucket_falls_back_per_miss``. The
port has no per-miss fallback on purpose: it mixed units (a static cost
beside measured milliseconds) and cannot be reached, because every chunk's
bucket comes from the plan's ``buckets`` and calibration times each of
them (``SnapshotServer._measured_cost``).
"""
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.dgnn import DGNNConfig as JConfig
from repro.graph.coo import COOSnapshot as JCOO
from repro.kernels import ops as jops
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import FaultSpec as JFaultSpec
from repro.serve import SnapshotServer as JServer
from repro_torch import api
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.graph.coo import COOSnapshot
from repro_torch.kernels import ops
from repro_torch.params import params_from_jax
from repro_torch.serve import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    PoolOverflow,
    SnapshotServer,
    SupervisionPolicy,
    TenantStatePool,
    TenantSupervisor,
)

SEED = int(os.environ.get("CHAOS_SEED", "0"))
N_GLOBAL = 32
# all generated streams fit the small bucket (see tests/test_chaos.py)
BUCKETS = ((16, 32, 8), (32, 64, 8))
CHUNK = 2
ATOL = 3e-4

_FAMILY_KW = {
    "gcrn": dict(name="sched-gcrn", dgnn_type="integrated", rnn="lstm"),
    "stacked": dict(name="sched-stacked", dgnn_type="stacked", rnn="gru"),
    "evolve": dict(name="sched-evolve", dgnn_type="weights_evolved",
                   rnn="gru"),
}
_COMMON = dict(gnn="gcn", dataflow="v3", in_dim=4, hidden=8, out_dim=4,
               n_gnn_layers=1, edge_dim=2)
FAMILIES = {f: DGNNConfig(**kw, **_COMMON) for f, kw in _FAMILY_KW.items()}
JFAMILIES = {f: JConfig(**kw, **_COMMON) for f, kw in _FAMILY_KW.items()}

_FEAT = np.asarray(
    np.random.default_rng(SEED).normal(size=(N_GLOBAL, 4)), np.float32)

# ragged arrivals: per-tenant stream lengths deliberately unequal
LENS = {"a": 7, "b": 3, "c": 5}
CONTINUOUS = dict(scheduler="continuous", state_pool_pages=2,
                  prefill_chunk=1)


def _make_snaps(stream_ix, n_snap, kind=COOSnapshot):
    r = np.random.default_rng(SEED * 7919 + stream_ix)
    out = []
    for t in range(n_snap):
        e = int(r.integers(3, 7))
        src = r.integers(0, N_GLOBAL, size=e)
        dst = r.choice(N_GLOBAL, size=e, replace=False)  # in-degree 1
        ef = np.asarray(r.normal(size=(e, 2)), np.float32)
        out.append(kind(src=src, dst=dst, edge_feat=ef, t_index=t))
    return out


def _streams(lens=LENS, kind=COOSnapshot):
    return {sid: _make_snaps(i, n, kind)
            for i, (sid, n) in enumerate(sorted(lens.items()))}


def _jax_params(family):
    model = japi.BoosterSession(JFAMILIES[family],
                                japi.plan(JFAMILIES[family], level="v3"),
                                n_global=N_GLOBAL).model
    return model.init(jax.random.PRNGKey(SEED))


def _server(family, **plan_kw):
    cfg = FAMILIES[family]
    plan = api.plan(cfg, level="v3", buckets=BUCKETS, stream_chunk=CHUNK,
                    **plan_kw)
    params = params_from_jax(cfg, jax.tree.map(np.asarray,
                                               _jax_params(family)))
    sess = api.BoosterSession(cfg, plan, n_global=N_GLOBAL,
                              feat_table=_FEAT, params=params, device="cpu")
    return SnapshotServer(session=sess)


def _init(srv, sids):
    params = srv.session.params
    return params, {sid: srv.model.init_state(params, mode=srv.mode)
                    for sid in sids}


def _serve(family, streams, **plan_kw):
    srv = _server(family, **plan_kw)
    params, states = _init(srv, streams)
    return srv.run_multi(params, states, streams)


def _jserve(family, lens=LENS, **plan_kw):
    """The JAX force-ref server on the same plan and streams."""
    cfg = JFAMILIES[family]
    plan = japi.plan(cfg, level="v3", buckets=BUCKETS, stream_chunk=CHUNK,
                     **plan_kw)
    sess = japi.BoosterSession(cfg, plan, n_global=N_GLOBAL,
                               feat_table=_FEAT, params=_jax_params(family))
    srv = JServer(session=sess)
    params = sess.params
    streams = _streams(lens, JCOO)
    states = {sid: srv.model.init_state(params, mode=srv.mode)
              for sid in streams}
    jops.set_force_ref(True)
    try:
        return srv.run_multi(params, states, streams)
    finally:
        jops.set_force_ref(False)


def _leaves(state):
    """The tensors of a state in jax.tree.leaves order (sorted keys)."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _leaves(v)]
    return [state]


def _assert_same_serve(streams, st_a, outs_a, st_b, outs_b, sids=None):
    for sid in sids if sids is not None else streams:
        assert len(outs_a[sid]) == len(outs_b[sid]) == len(streams[sid])
        for t, (x, y) in enumerate(zip(outs_a[sid], outs_b[sid])):
            np.testing.assert_array_equal(x, y, err_msg=f"{sid} t={t}")
        la, lb = _leaves(st_a[sid]), _leaves(st_b[sid])
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), sid


def _assert_matches_jax(st, outs, stats, jres, sids=None):
    """Outputs and final states within 3e-4 of the JAX server's, and the
    counters a run fixes equal (trouble-free of tick timing)."""
    jst, jouts, jstats = jres
    assert set(stats.tenant_errors) == set(jstats.tenant_errors)
    assert stats.live_snapshots == jstats.live_snapshots
    assert stats.recoveries == stats.evictions
    assert jstats.recoveries == jstats.evictions
    assert ({sid: len(v) for sid, v in stats.commit_ms.items()}
            == {sid: len(v) for sid, v in jstats.commit_ms.items()})
    for sid in sids if sids is not None else jouts:
        assert len(outs[sid]) == len(jouts[sid]), sid
        for got, want in zip(outs[sid], jouts[sid]):
            np.testing.assert_allclose(got, want, atol=ATOL)
        assert (sid in st) == (sid in jst), sid  # express: stateless
        if stats.tenants[sid].ok and sid in jst:
            want = jax.tree.leaves(jax.tree.map(np.asarray, jst[sid]))
            got = _leaves(st[sid])
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_allclose(x.numpy(), y, atol=ATOL)


def _assert_no_serve_threads():
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("dgnn-serve")]
    assert not leaked, f"leaked serve threads: {leaked}"


# ------------------------------------------------ differential equivalence ----


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_continuous_matches_rounds_bit_identical(family):
    """Continuous scheduling (any tick composition, pool pressure: 2 pages
    for 3 tenants, so an ACTIVE tenant is evicted and recovered mid-stream,
    chunked prefill) serves every tenant bit for bit as the round loop
    does, outputs and final states both, under ragged arrivals; and within
    3e-4 of the JAX continuous server."""
    streams = _streams()
    st_r, outs_r, stats_r = _serve(family, streams)
    st_c, outs_c, stats_c = _serve(family, streams, **CONTINUOUS)
    _assert_same_serve(streams, st_r, outs_r, st_c, outs_c)
    assert stats_r.ticks == 0  # the round loop reports no ticks
    assert stats_c.ticks > 0
    # 3 tenants through 2 pages: eviction and recovery really happen, and
    # every spill was paged back in (the flush included)
    assert stats_c.evictions > 0
    assert stats_c.recoveries == stats_c.evictions
    # every committed snapshot carries a commit timestamp
    assert {sid: len(v) for sid, v in stats_c.commit_ms.items()} == \
        {sid: len(s) for sid, s in streams.items()}
    _assert_matches_jax(st_c, outs_c, stats_c, _jserve(family, **CONTINUOUS))
    _assert_no_serve_threads()


def test_chunked_prefill_interleaves_backlog():
    """A tenant with a deep backlog is served ``prefill_chunk`` snapshots a
    tick, interleaved with the incremental tenants, and the chunking is
    invisible in the outputs (bit for bit the round-based run)."""
    lens = {"deep": 16, "x": 3, "y": 3}
    streams = _streams(lens)
    st_r, outs_r, _ = _serve("gcrn", streams)
    # queue_depth > backlog so the producer hands the whole backlog to the
    # first admission pass and the prefill quota provably engages
    kw = dict(scheduler="continuous", prefill_chunk=1, queue_depth=32)
    st_c, outs_c, stats = _serve("gcrn", streams, **kw)
    _assert_same_serve(streams, st_r, outs_r, st_c, outs_c)
    assert stats.prefill_chunks > 0
    # the deep tenant needed many ticks; the incremental tenants' ticks
    # ran inside them, not after
    assert stats.ticks >= 16 // CHUNK
    jres = _jserve("gcrn", lens, **kw)
    assert jres[2].prefill_chunks > 0 and jres[2].ticks >= 16 // CHUNK
    _assert_matches_jax(st_c, outs_c, stats, jres)


def test_forced_eviction_recovery_is_bit_exact_evolvegcn():
    """A 1-page pool over 3 tenants forces an eviction and a recovery on
    nearly every tick; the family whose state is its evolving weight
    matrices must serve bit for bit regardless."""
    streams = _streams()
    st_r, outs_r, _ = _serve("evolve", streams)
    kw = dict(scheduler="continuous", state_pool_pages=1)
    st_c, outs_c, stats = _serve("evolve", streams, **kw)
    _assert_same_serve(streams, st_r, outs_r, st_c, outs_c)
    assert stats.evictions >= 2
    assert stats.recoveries == stats.evictions
    # per-tenant counters surfaced through the supervision results
    assert sum(r.evictions for r in stats.tenants.values()) == stats.evictions
    jres = _jserve("evolve", **kw)
    assert jres[2].evictions >= 2
    _assert_matches_jax(st_c, outs_c, stats, jres)


# ------------------------------------------------------- state pool unit ----


def test_tenant_state_pool_paging_unit():
    """Block-table locations, LRU victim order, bit-exact host round trips,
    overflow rejection, end-of-run flush."""
    sids = ["a", "b", "c"]
    sup = TenantSupervisor(sids, SupervisionPolicy(isolate=True))
    mk = lambda i: {"h": torch.arange(4, dtype=torch.float32) * (i + 1),
                    "c": torch.ones((2, 2)) * (i + 1)}
    states = {sid: mk(i) for i, sid in enumerate(sids)}
    want = {sid: {k: v.clone() for k, v in s.items()}
            for sid, s in states.items()}
    pool = TenantStatePool(states, pages=2, supervisor=sup)
    # over-committed at construction: spilled down to capacity
    assert len(pool.resident) == 2 and len(pool.host_pages) == 1
    assert pool.location("a") == "host"  # the first in repr order
    # acquiring the evicted tenant pages it back in, evicting the LRU
    # resident that is NOT in the working set
    (victim,) = set(sids) - pool.resident
    pool.acquire([victim])
    assert pool.location(victim) == "device"
    assert len(pool.resident) == 2
    # LRU: 'victim' is now MRU; acquiring the other evicted tenant must
    # not evict it
    (other,) = set(sids) - pool.resident
    pool.acquire([other])
    assert pool.location(victim) == "device"
    assert pool.location(other) == "device"
    with pytest.raises(PoolOverflow):
        pool.acquire(sids)
    with pytest.raises(KeyError):
        pool.location("nope")
    pool.flush()
    assert not pool.host_pages and pool.resident == set(sids)
    for sid in sids:  # the fp32 host round trip is bit-exact
        assert all(torch.equal(states[sid][k], want[sid][k])
                   for k in want[sid])
    totals = sup.totals()
    assert totals["evictions"] == totals["recoveries"] > 0


def test_tenant_state_pool_hbm_paged_capacity_lift():
    """Under ``state_residency='hbm_paged'`` the pool's effective capacity
    is ``pages * HBM_PAGE_FACTOR``, the JAX package's factor, so a plan
    evicts as often in both packages."""
    from repro.serve.state_pool import HBM_PAGE_FACTOR as JFACTOR
    from repro_torch.serve.state_pool import HBM_PAGE_FACTOR

    assert HBM_PAGE_FACTOR == JFACTOR
    sids = [f"t{i}" for i in range(5)]
    sup = TenantSupervisor(sids, SupervisionPolicy(isolate=True))
    mk = lambda: {"h": torch.zeros(4)}
    # resident pool: 5 tenants over a 2-page budget spills 3
    vm = TenantStatePool({s: mk() for s in sids}, pages=2,
                         supervisor=sup, residency="vmem")
    assert vm.capacity == 2 and len(vm.host_pages) == 3
    # paged pool: same nominal budget, 2 * HBM_PAGE_FACTOR effective pages
    sup2 = TenantSupervisor(sids, SupervisionPolicy(isolate=True))
    hp = TenantStatePool({s: mk() for s in sids}, pages=2,
                         supervisor=sup2, residency="hbm_paged")
    assert hp.capacity == 2 * HBM_PAGE_FACTOR
    assert not hp.host_pages and hp.resident == set(sids)
    hp.acquire(sids)  # would raise PoolOverflow on the resident pool
    with pytest.raises(PoolOverflow):
        vm.acquire(sids)
    # pages=None stays unbounded in both residencies
    assert TenantStatePool({s: mk() for s in sids}, pages=None,
                           supervisor=sup2,
                           residency="hbm_paged").capacity is None
    with pytest.raises(ValueError, match="pages=0"):
        TenantStatePool({}, pages=0, supervisor=sup2)


def test_paged_plan_evicts_as_its_capacity_implies():
    """An hbm_paged plan with 1 nominal page holds HBM_PAGE_FACTOR tenants:
    12 tenants evict, and the outputs and final states equal the round
    scheduler's on the same paged plan bit for bit."""
    from repro_torch.serve.state_pool import HBM_PAGE_FACTOR

    lens = {f"t{i:02d}": 2 + i % 3 for i in range(12)}
    streams = _streams(lens)
    paged = dict(state_residency="hbm_paged", td=8)
    st_r, outs_r, _ = _serve("gcrn", streams, **paged)
    st_c, outs_c, stats = _serve("gcrn", streams, scheduler="continuous",
                                 state_pool_pages=1, **paged)
    _assert_same_serve(streams, st_r, outs_r, st_c, outs_c)
    # the pool starts over-committed: 12 - 8 tenants spill before a tick
    assert stats.evictions >= len(lens) - HBM_PAGE_FACTOR
    assert stats.recoveries == stats.evictions


# ------------------------------------------------------ chaos under ticks ----


def test_continuous_quarantine_leaves_survivors_bit_identical():
    """A persistent launch fault pinned to tenant 'b' quarantines it while
    the survivors (co-batched across arbitrary tick compositions, through
    pool evictions) end bit for bit as a fault-free ROUND-BASED run; the
    JAX continuous server quarantines the same tenant."""
    streams = _streams()
    st_base, outs_base, _ = _serve("gcrn", streams)
    spec = dict(site="launch", tenant="b", index=0, count=99)
    kw = dict(scheduler="continuous", state_pool_pages=2,
              supervision="isolate")
    st, outs, stats = _serve("gcrn", streams, fault_plan=FaultPlan(
        specs=(FaultSpec(**spec),), seed=SEED), **kw)
    assert isinstance(stats.tenants["b"].error, InjectedFault)
    assert len(outs["b"]) < LENS["b"]
    for sid in ("a", "c"):
        assert stats.tenants[sid].ok
        for got, base in zip(outs[sid], outs_base[sid]):
            np.testing.assert_array_equal(got, base)
        assert all(torch.equal(x, y) for x, y
                   in zip(_leaves(st[sid]), _leaves(st_base[sid])))
    jres = _jserve("gcrn", fault_plan=JFaultPlan(
        specs=(JFaultSpec(**spec),), seed=SEED), **kw)
    assert set(jres[2].tenant_errors) == {"b"}
    _assert_matches_jax(st, outs, stats, jres, sids=("a", "c"))
    _assert_no_serve_threads()


def test_continuous_transient_fault_retried_from_checkpoint():
    """A transient launch fault under the scheduler is replayed from the
    rolled-back checkpoint: nobody is quarantined and the evolving weights
    advance exactly once per served snapshot (final state equals the
    fault-free run EXACTLY)."""
    streams = _streams()
    st_base, outs_base, _ = _serve("evolve", streams)
    spec = dict(site="launch", index=0, count=1)
    kw = dict(scheduler="continuous", state_pool_pages=2,
              supervision="isolate", max_retries=2, retry_backoff_ms=1.0)
    st, outs, stats = _serve("evolve", streams, fault_plan=FaultPlan(
        specs=(FaultSpec(**spec),), seed=SEED), **kw)
    assert not stats.tenant_errors
    assert stats.retries >= 1 and stats.rollbacks >= 1
    _assert_same_serve(streams, st_base, outs_base, st, outs)
    jres = _jserve("evolve", fault_plan=JFaultPlan(
        specs=(JFaultSpec(**spec),), seed=SEED), **kw)
    assert jres[2].retries >= 1
    _assert_matches_jax(st, outs, stats, jres)


@pytest.mark.parametrize("error", [RuntimeError, OSError])
@pytest.mark.parametrize("supervision", ["isolate", "strict"])
def test_broken_kernel_is_never_served_by_the_oracle(monkeypatch, error,
                                                     supervision):
    """tests/test_torch_chaos.py's case under the continuous scheduler: a
    kernel that fails to build, load or launch raises a plain error, so
    with degrade=True the ladder stops at the solo kernel launch; the
    oracle rung is never launched and no output is degraded. Under isolate
    every tenant is quarantined with the kernel's error; under strict that
    error propagates after a clean shutdown."""
    oracles, _, *rest = ops._STREAM_DISPATCH["gcrn"]

    def broken(batched, *args, **kwargs):
        raise error("the gcrn engine did not build")

    monkeypatch.setitem(ops._STREAM_DISPATCH, "gcrn",
                        (oracles, broken, *rest))
    routes = []
    prev = ops.set_fault_hook(
        lambda *, family, batched, force_ref: routes.append(force_ref))
    streams = _streams()
    try:
        srv = _server("gcrn", supervision=supervision, degrade=True,
                      **CONTINUOUS)
        params, states = _init(srv, streams)
        if supervision == "strict":
            with pytest.raises(error, match="did not build"):
                srv.run_multi(params, states, streams)
        else:
            _, outs, stats = srv.run_multi(params, states, streams)
    finally:
        ops.set_fault_hook(prev)
    _assert_no_serve_threads()
    assert routes and True not in routes  # the oracle rung never launched
    if supervision == "strict":
        return
    assert stats.degraded_launches == 0
    assert set(stats.tenant_errors) == set(streams)
    assert all(isinstance(e, error) for e in stats.tenant_errors.values())
    assert all(outs[sid] == [] for sid in streams)
    assert stats.launches == len(routes)


# ------------------------------------------ calibration under the guard ----


def test_calibration_never_leaks_into_stats():
    """Measured-guard calibration launches are warm-up, not serving: every
    ServeStats counter and the output stream are IDENTICAL between
    ``promotion_guard="measured"`` and ``"static"`` on a fault-free run."""
    streams = _streams()
    runs = {}
    for guard in ("static", "measured"):
        runs[guard] = _serve("gcrn", streams, promote_buckets=100.0,
                             promotion_guard=guard)
    st_s, outs_s, stats_s = runs["static"]
    st_m, outs_m, stats_m = runs["measured"]
    assert stats_m.calibration_fallback is None  # calibration succeeded
    _assert_same_serve(streams, st_s, outs_s, st_m, outs_m)
    for f in ("launches", "live_snapshots", "padded_snapshots",
              "promoted_chunks", "retries", "rollbacks",
              "degraded_launches", "timeouts", "ticks", "prefill_chunks"):
        assert getattr(stats_s, f) == getattr(stats_m, f), f
    assert len(stats_s.per_snapshot_ms) == len(stats_m.per_snapshot_ms)


def test_calibration_never_leaks_into_fault_windows():
    """An occurrence-indexed launch fault fires on the same REAL launch
    whether or not calibration ran inside the first tick: calibration
    launches are exempt from launch-site counting, and host-site probes
    from producer threads are counted even while the calibration window's
    ``_fault_exempt`` flag is up."""
    streams = _streams()
    outcomes = {}
    for guard in ("static", "measured"):
        fp = FaultPlan(specs=(FaultSpec(site="launch", tenant="b", index=0,
                                        count=99),), seed=SEED)
        st, outs, stats = _serve("gcrn", streams, scheduler="continuous",
                                 promote_buckets=100.0,
                                 promotion_guard=guard,
                                 supervision="isolate", fault_plan=fp)
        assert isinstance(stats.tenants["b"].error, InjectedFault)
        outcomes[guard] = {sid: len(outs[sid]) for sid in streams}
    assert outcomes["static"] == outcomes["measured"]
    # the concurrency half, pinned directly: _probe ignores _fault_exempt
    srv = _server("gcrn", supervision="isolate", fault_plan=FaultPlan(
        specs=(FaultSpec(site="preprocess", tenant="a", index=0),),
        seed=SEED))
    srv._fault_exempt = True  # a calibration window open on another thread
    with pytest.raises(InjectedFault):
        srv._probe("preprocess", tenant="a")


# ------------------------------------------------------ plan validation ----


@pytest.mark.parametrize("kwargs", [
    dict(scheduler="sometimes"),
    dict(level="v2", scheduler="continuous"),
    dict(state_pool_pages=4),
    dict(scheduler="continuous", state_pool_pages=0),
    dict(prefill_chunk=2),
    dict(scheduler="continuous", stream_chunk=4, prefill_chunk=8),
])
def test_plan_validates_scheduler_fields(kwargs):
    """The port's plan() refuses what repro.api.plan refuses, with the
    same message; a valid continuous plan keeps its fields."""
    cfg, jcfg = FAMILIES["gcrn"], JFAMILIES["gcrn"]
    plan = api.plan(cfg, level="v3", scheduler="continuous",
                    state_pool_pages=4, prefill_chunk=2)
    assert (plan.scheduler, plan.state_pool_pages, plan.prefill_chunk) == \
        ("continuous", 4, 2)
    kw = dict(dict(level="v3"), **kwargs)
    with pytest.raises(ValueError) as want:
        japi.plan(jcfg, **kw)
    with pytest.raises(ValueError) as got:
        api.plan(cfg, **kw)
    assert str(got.value) == str(want.value)


# --------------------------------------------------- the express lane ----


def _mixed(scheduler, **gplan):
    """A GCRN server with a static-GCN express lane, both packages, on the
    same parameters (tests/test_temporal.py's mixed server, at its
    scheduler)."""
    gcfg, scfg = FAMILIES["gcrn"], DGNNConfig(
        name="sched-static", dgnn_type="static", rnn="none", **_COMMON)
    jgcfg, jscfg = JFAMILIES["gcrn"], JConfig(
        name="sched-static", dgnn_type="static", rnn="none", **_COMMON)
    bucket = dict(n_pad=BUCKETS[0][0], e_pad=BUCKETS[0][1],
                  k_max=BUCKETS[0][2])
    kw = dict(level="v3", stream_chunk=4, supervision="isolate",
              scheduler=scheduler, **bucket, **gplan)
    jparams = _jax_params("gcrn")
    jsess = japi.BoosterSession(jscfg, japi.plan(jscfg, level="v3",
                                                 **bucket),
                                n_global=N_GLOBAL, feat_table=_FEAT)
    jxparams = jsess.model.init(jax.random.PRNGKey(SEED + 1))
    jsrv = JServer(session=japi.BoosterSession(
        jgcfg, japi.plan(jgcfg, **kw), n_global=N_GLOBAL, feat_table=_FEAT,
        params=jparams), express=jsess)
    params = params_from_jax(gcfg, jax.tree.map(np.asarray, jparams))
    xparams = params_from_jax(scfg, jax.tree.map(np.asarray, jxparams))
    xsess = api.BoosterSession(scfg, api.plan(scfg, level="v3", **bucket),
                               n_global=N_GLOBAL, feat_table=_FEAT,
                               params=xparams, device="cpu")
    srv = SnapshotServer(session=api.BoosterSession(
        gcfg, api.plan(gcfg, **kw), n_global=N_GLOBAL, feat_table=_FEAT,
        params=params, device="cpu"), express=xsess)
    return (srv, params, xsess, xparams), (jsrv, jparams, jsess, jxparams)


def _serve_mixed(servers, lens, xlens, kind):
    srv, params, _, xparams = servers
    streams = _streams(lens, kind)
    xstreams = {sid: _make_snaps(100 + i, n, kind)
                for i, (sid, n) in enumerate(sorted(xlens.items()))}
    states = {sid: srv.model.init_state(params, mode="v3")
              for sid in streams}
    jops.set_force_ref(kind is JCOO)  # the JAX side: its oracle
    try:
        return srv.run_multi(params, states, streams,
                             express_streams=xstreams,
                             express_params=xparams), streams, xstreams
    finally:
        jops.set_force_ref(False)


def test_serve_express_coexists_with_recurrent():
    """tests/test_temporal.py's continuous case: express tenants beside
    recurrent ones under the continuous scheduler. Express outputs equal
    the static model's solo forwards, recurrent outputs equal serving them
    alone, both within 3e-4 of the JAX continuous server, and the launch
    split shows in the stats."""
    from repro_torch.graph.csr import renumber_and_normalize
    from repro_torch.graph.padding import pad_snapshot

    port, jax_side = _mixed("continuous", state_pool_pages=2)
    lens, xlens = {"a": 6, "b": 7}, {"x1": 5, "x2": 7}
    (st, outs, stats), streams, xstreams = _serve_mixed(port, lens, xlens,
                                                        COOSnapshot)
    jres, _, _ = _serve_mixed(jax_side, lens, xlens, JCOO)
    _assert_matches_jax(st, outs, stats, jres)
    srv, params, xsess, xparams = port
    for sid, ss in xstreams.items():
        assert len(outs[sid]) == len(ss)
        for o, s in zip(outs[sid], ss):
            ps = pad_snapshot(renumber_and_normalize(s), _FEAT, *BUCKETS[0])
            _, want = xsess.model.step(xparams, {}, ps.to("cpu"))
            np.testing.assert_allclose(o, want.numpy(), atol=1e-5)
    for sid, ss in streams.items():
        _, solo, _ = srv.run(params, srv.model.init_state(params, mode="v3"),
                             ss)
        assert len(outs[sid]) == len(solo)
        for a, b in zip(outs[sid], solo):
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert stats.ticks > 0
    assert stats.express_launches > 0
    assert (stats.launches_by_family.get("static_gcn", 0)
            == stats.express_launches)
    assert stats.launches_by_family.get("gcrn", 0) > 0
    assert stats.launches == sum(stats.launches_by_family.values())
    _assert_no_serve_threads()


def test_serve_scale_mixed_traffic_no_thread_leak():
    """tests/test_temporal.py's mixed-traffic case: 16 recurrent and 48
    express tenants through the continuous scheduler: every tenant fully
    served, the per-family launch counters consistent, every producer
    thread joined at exit, and the outputs within 3e-4 of the JAX
    continuous server's."""
    port, jax_side = _mixed("continuous", state_pool_pages=2)
    lens = {f"r{i:02d}": 2 for i in range(16)}
    xlens = {f"x{i:02d}": 1 for i in range(48)}
    before = threading.active_count()
    (st, outs, stats), streams, xstreams = _serve_mixed(port, lens, xlens,
                                                        COOSnapshot)
    _assert_no_serve_threads()
    assert threading.active_count() <= before
    assert all(len(outs[sid]) == len(streams[sid]) for sid in streams)
    assert all(len(outs[sid]) == len(xstreams[sid]) for sid in xstreams)
    assert stats.express_launches > 0
    assert (stats.launches_by_family.get("static_gcn", 0)
            == stats.express_launches)
    assert stats.launches == sum(stats.launches_by_family.values())
    assert stats.ticks > 0
    assert not stats.tenant_errors
    jres, _, _ = _serve_mixed(jax_side, lens, xlens, JCOO)
    _assert_matches_jax(st, outs, stats, jres)


# ------------------------------------------------------- the port's own ----


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_step_bits_on_the_cpu(cell):
    """What the CPU plain path promises across tick compositions. At this
    file's widths (16 rows, 8 units) a stream's rows of a plain cell step
    are bit for bit the same whatever the launch's batch, which the
    bit-for-bit cases above rest on. At a served model's width (640 rows,
    128 units) torch's CPU elementwise kernels may round a row's last bit
    differently inside a larger batch (vectorised and scalar paths split a
    tensor by its size), so there a continuous serve equals the round
    serve within 1e-6 (tests/test_torch_serve.py, ROADMAP queue 3); the
    CUDA kernels are held bit for bit on the card (chip_smoke.py)."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(SEED)
    for (n, H), exact in (((16, 8), True), ((640, 128), False)):
        x, h, c = (torch.randn(3, n, H, generator=g) for _ in range(3))
        k = 4 if cell == "lstm" else 3
        wx, wh = (torch.randn(H, k * H, generator=g) for _ in range(2))
        b = torch.randn(k * H, generator=g)
        step = ((lambda s: ref.fused_lstm(x[s], h[s], c[s], wx, wh, b)[0])
                if cell == "lstm"
                else (lambda s: ref.fused_gru(x[s], h[s], wx, wh, b)))
        alone, batched = step(slice(0, 1)), step(slice(0, 3))[:1]
        if exact:
            assert torch.equal(alone, batched), (n, H)
        else:
            torch.testing.assert_close(alone, batched, atol=1e-6, rtol=0)


def test_evolve_edge_term_bits_do_not_depend_on_the_launch():
    """EvolveGCN's pre-aggregated edge term, built on the host for each
    launch, has the same bits for a snapshot whatever the launch's B and T
    (its sums run in a fixed elementwise order): the continuous
    scheduler's chunking must not change what a tenant is served."""
    from repro_torch.graph.csr import renumber_and_normalize
    from repro_torch.graph.padding import pad_snapshot, stack_streams
    from repro_torch.core.dataflow import stack_time

    srv = _server("evolve")
    params = srv.session.params
    streams = _streams({"a": 8, "b": 8, "c": 8})
    chunks = {sid: stack_time([pad_snapshot(renumber_and_normalize(s), _FEAT,
                                            *BUCKETS[0]) for s in snaps])
              for sid, snaps in streams.items()}
    whole = srv.model._edge_aggs(params, stack_streams(
        [chunks[sid] for sid in sorted(chunks)]).to("cpu"))
    for t0, t1 in ((0, 2), (2, 3), (3, 8)):
        part = stack_streams([stack_time([pad_snapshot(
            renumber_and_normalize(s), _FEAT, *BUCKETS[0])
            for s in streams["b"][t0:t1]])]).to("cpu")
        got = srv.model._edge_aggs(params, part)
        assert torch.equal(got[0], whole[1, t0:t1]), (t0, t1)


def _storages(states: dict) -> dict:
    return {sid: [t.untyped_storage() for t in _leaves(st)]
            for sid, st in states.items()}


@pytest.mark.parametrize("kw", [{}, dict(scheduler="continuous"),
                                CONTINUOUS],
                         ids=["rounds", "continuous", "continuous-paged"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_committed_states_own_their_storage(family, kw):
    """A committed tenant state is a copy of its rows, not a view into its
    launch's (B, ...) batch: no two tenants' tensors share storage, and
    each tensor's storage holds that tensor alone. A view would keep the
    whole batch alive while any co-batched tenant's state lives, so the
    pool could bound nothing on the card."""
    streams = _streams()
    st, outs, stats = _serve(family, streams, **kw)
    assert stats.launches < sum(len(s) for s in streams.values())
    owners: dict = {}
    for sid, stores in _storages(st).items():
        for t, store in zip(_leaves(st[sid]), stores):
            assert store.nbytes() == t.numel() * t.element_size(), sid
            assert owners.setdefault(store.data_ptr(), sid) == sid
    # and the commit copies: every co-batched launch still serves the
    # same bits (the round scheduler on the same plan)
    if kw:
        st_r, outs_r, _ = _serve(family, streams)
        _assert_same_serve(streams, st_r, outs_r, st, outs)


def test_producer_threads_do_no_torch_work(monkeypatch):
    """Producer threads do numpy work only under the continuous scheduler
    too: every torch call that makes, moves or reads back a tensor
    (eviction's copy to the host and recovery's copy back included) runs
    on the device loop's thread."""
    from repro_torch.graph import padding as tpad

    seen = []

    def recorded(fn):
        def call(*a, **k):
            seen.append(threading.current_thread().name)
            return fn(*a, **k)
        return call

    for mod, name in ((torch, "as_tensor"), (torch, "tensor"),
                      (torch, "stack"), (torch, "zeros_like"),
                      (torch, "clone"), (torch.Tensor, "to"),
                      (torch.Tensor, "cpu"), (tpad.PaddedSnapshot, "to")):
        monkeypatch.setattr(mod, name, recorded(getattr(mod, name)))
    streams = _streams()
    st, outs, stats = _serve("gcrn", streams, scheduler="continuous",
                             state_pool_pages=1)
    assert stats.evictions > 0
    assert seen and not [t for t in seen if t.startswith("dgnn-serve")]


def test_strict_error_propagates_past_the_flush(monkeypatch):
    """Under strict supervision a launch error ends the run while tenants
    sit on the host. If the end-of-run flush then fails too (a CUDA error
    that sticks to the context fails every later copy), the error that
    leaves run_multi is the launch's own, after a clean shutdown."""
    srv = _server("gcrn", scheduler="continuous", state_pool_pages=1)
    params, states = _init(srv, LENS)
    real = srv._launch_ragged
    launches = []

    def launch(*a, **k):
        launches.append(1)
        if len(launches) == 3:
            raise RuntimeError("an illegal memory access was encountered")
        return real(*a, **k)

    def sticky(self, states, sid, page):
        if len(launches) >= 3:
            raise RuntimeError("the context is lost")
        return recover(self, states, sid, page)

    recover = TenantSupervisor.recover_from_host
    srv._launch_ragged = launch
    monkeypatch.setattr(TenantSupervisor, "recover_from_host", sticky)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        srv.run_multi(params, states, _streams())
    assert len(launches) == 3
    _assert_no_serve_threads()
    # without a failure, a flush error is the run's own and propagates
    monkeypatch.undo()
    srv = _server("gcrn", scheduler="continuous", state_pool_pages=1)
    params, states = _init(srv, LENS)

    def flush(self):
        raise RuntimeError("the flush failed")

    monkeypatch.setattr(TenantStatePool, "flush", flush)
    with pytest.raises(RuntimeError, match="the flush failed"):
        srv.run_multi(params, states, _streams())
    _assert_no_serve_threads()


def test_scheduler_modules_are_lint_clean():
    """``python -m repro.analysis``'s lint rules over the two new modules:
    zero findings and zero suppressions (the scheduler catches
    ``faults.SUPERVISED``, never a broad except)."""
    from pathlib import Path

    from repro.analysis import core, lint

    root = Path(__file__).resolve().parents[1]
    files = ["src/repro_torch/serve/scheduler.py",
             "src/repro_torch/serve/state_pool.py"]
    report = core.Report(rules_run=tuple(sorted(lint.RULES)))
    findings = core.apply_suppressions(
        lint.run_lint(root, files=files, rules=frozenset(lint.RULES)), root,
        report)
    assert findings == [] and report.suppressed == 0
    for f in files:
        assert "booster: ignore" not in (root / f).read_text(), f
