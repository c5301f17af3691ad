"""The port's supervision contract on the CPU: tests/test_chaos.py, case for
case, on ``repro_torch.serve``, held against the port's own fault-free run
and against the JAX server running the same fault plan.

What these tests pin:

  * every fault site (preprocess / bucket / launch / evolve) x every
    recurrent family: the targeted tenant is quarantined, the surviving
    tenants' outputs and final states are bit-identical to the fault-free
    run, and the stats equal the JAX server's under the same plan;
  * a transient launch fault is retried from the rolled-back checkpoint
    (EvolveGCN's weights advance exactly once per live snapshot), and a
    mid-commit fault's partial write is rolled back;
  * the degradation ladder: batched -> solo -> the plain PyTorch oracle;
  * launch deadlines: an overdue launch is discarded, counted, retried;
  * shutdown leaves no producer thread behind, on success and failure;
  * malformed snapshots are rejected at the serve boundary with typed,
    tenant-attributed errors;
  * what is the port's own: a launch leaves its input state tensors
    unchanged (so the reference checkpoint is complete), an error outside
    ``faults.SUPERVISED`` propagates after a clean shutdown, and the
    launch-site hook fires once a launch on both routes.

The JAX server runs under ``ops.set_force_ref(True)`` (its stream engine
does not build with the installed jax, ROADMAP queue 3), so a
``scope="kernel"`` fault never fires there: that case holds the port
against its own fault-free run and the JAX fault-free run.
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
from repro_torch.graph.padding import bucket_cost
from repro_torch.kernels import ops
from repro_torch.params import params_from_jax
from repro_torch.serve import (
    SUPERVISED,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    SnapshotServer,
    SnapshotValidationError,
    TenantSupervisor,
    SupervisionPolicy,
    validate_snapshot,
)
from repro_torch.serve.supervision import map_state

CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "0"))
N_GLOBAL = 32
# streams always fit the SMALL bucket, so every chunk of every tenant
# co-buckets and each round is exactly one batched launch
BUCKETS = ((16, 32, 8), (32, 64, 8))
SIDS = ("a", "b", "c")
N_SNAP = 4
CHUNK = 2
ATOL = 3e-4

_FAMILY_KW = {
    "gcrn": dict(name="chaos-gcrn", dgnn_type="integrated", rnn="lstm"),
    "stacked": dict(name="chaos-stacked", dgnn_type="stacked", rnn="gru"),
    "evolve": dict(name="chaos-evolve", dgnn_type="weights_evolved",
                   rnn="gru"),
}
_COMMON = dict(gnn="gcn", dataflow="v3", in_dim=4, hidden=8, out_dim=4,
               n_gnn_layers=1, edge_dim=2)
FAMILIES = {f: DGNNConfig(**kw, **_COMMON) for f, kw in _FAMILY_KW.items()}
JFAMILIES = {f: JConfig(**kw, **_COMMON) for f, kw in _FAMILY_KW.items()}
STATS = ("launches", "live_snapshots", "padded_snapshots", "promoted_chunks",
         "retries", "rollbacks", "degraded_launches", "timeouts")

_FEAT = np.asarray(
    np.random.default_rng(CHAOS_SEED).normal(size=(N_GLOBAL, 4)), np.float32)


def _make_snaps(stream_ix, n_snap=N_SNAP, kind=COOSnapshot):
    r = np.random.default_rng(CHAOS_SEED * 7919 + stream_ix)
    out = []
    for t in range(n_snap):
        e = int(r.integers(3, 7))
        src = r.integers(0, N_GLOBAL, size=e)
        dst = r.choice(N_GLOBAL, size=e, replace=False)  # in-degree 1
        ef = np.asarray(r.normal(size=(e, 2)), np.float32)
        out.append(kind(src=src, dst=dst, edge_feat=ef, t_index=t))
    return out


def _streams(kind=COOSnapshot):
    return {sid: _make_snaps(i, kind=kind) for i, sid in enumerate(SIDS)}


def _jax_params(family):
    model = japi.BoosterSession(JFAMILIES[family],
                                japi.plan(JFAMILIES[family], level="v3"),
                                n_global=N_GLOBAL).model
    return model.init(jax.random.PRNGKey(CHAOS_SEED))


def _server(family, level="v3", **plan_kw):
    cfg = FAMILIES[family]
    plan = api.plan(cfg, level=level, buckets=BUCKETS, stream_chunk=CHUNK,
                    **plan_kw)
    params = params_from_jax(cfg, jax.tree.map(np.asarray,
                                               _jax_params(family)))
    sess = api.BoosterSession(cfg, plan, n_global=N_GLOBAL,
                              feat_table=_FEAT, params=params, device="cpu")
    return SnapshotServer(session=sess)


def _jserver(family, level="v3", **plan_kw):
    cfg = JFAMILIES[family]
    plan = japi.plan(cfg, level=level, buckets=BUCKETS, stream_chunk=CHUNK,
                     **plan_kw)
    sess = japi.BoosterSession(cfg, plan, n_global=N_GLOBAL,
                               feat_table=_FEAT, params=_jax_params(family))
    return JServer(session=sess)


def _plans(*specs):
    """The same fault plan for both packages, from FaultSpec kwargs."""
    return (FaultPlan(specs=tuple(FaultSpec(**s) for s in specs),
                      seed=CHAOS_SEED),
            JFaultPlan(specs=tuple(JFaultSpec(**s) for s in specs),
                       seed=CHAOS_SEED))


def _init(srv):
    params = srv.session.params
    return params, {sid: srv.model.init_state(params, mode=srv.mode)
                    for sid in SIDS}


def _run_jax(family, level="v3", **plan_kw):
    """The JAX force-ref server on the same plan and streams."""
    jops.set_force_ref(True)
    try:
        srv = _jserver(family, level=level, **plan_kw)
        params = srv.session.params
        states = {sid: srv.model.init_state(params, mode=srv.mode)
                  for sid in SIDS}
        return srv.run_multi(params, states, _streams(JCOO))
    finally:
        jops.set_force_ref(False)


def _leaves(state):
    """The tensors of a state in jax.tree.leaves order (sorted keys)."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _leaves(v)]
    return [state]


def _assert_state_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _assert_matches_jax(st, outs, stats, jres, sids=SIDS):
    """Outputs and states at 3e-4 of the JAX server's, its counters and
    quarantines exactly."""
    jst, jouts, jstats = jres
    for name in STATS:
        assert getattr(stats, name) == getattr(jstats, name), name
    assert set(stats.tenant_errors) == set(jstats.tenant_errors)
    for sid in sids:
        assert len(outs[sid]) == len(jouts[sid]), sid
        for got, want in zip(outs[sid], jouts[sid]):
            np.testing.assert_allclose(got, want, atol=ATOL)
        if stats.tenants[sid].ok:
            want = jax.tree.leaves(jax.tree.map(np.asarray, jst[sid]))
            for x, y in zip(_leaves(st[sid]), want):
                np.testing.assert_allclose(x.numpy(), y, atol=ATOL)


def _assert_no_serve_threads():
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("dgnn-serve")]
    assert not leaked, f"leaked serve threads: {leaked}"


@pytest.fixture(scope="module")
def baseline():
    """Fault-free run_multi per family: the oracle the chaos runs'
    survivors must match bit for bit."""
    res = {}
    for fam in sorted(FAMILIES):
        srv = _server(fam)
        params, states = _init(srv)
        st, outs, stats = srv.run_multi(params, states, _streams())
        assert not stats.tenant_errors
        assert all(len(v) == N_SNAP for v in outs.values())
        res[fam] = (st, outs)
    _assert_no_serve_threads()
    return res


# --------------------------------------------- site x family isolation ----


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("site", ["preprocess", "bucket", "launch", "evolve"])
def test_fault_site_isolates_tenant(family, site, baseline):
    """Every fault site x every family: tenant 'b' is quarantined with the
    injected error attributed to it; the survivors' outputs AND final
    states are bit-identical to the fault-free run; the JAX server on the
    same plan quarantines the same tenant with the same counters."""
    if site in ("preprocess", "bucket"):
        spec = dict(site=site, tenant="b", index=2)
    else:
        spec = dict(site=site, tenant="b", index=0, count=99)
    fp, jfp = _plans(spec)
    srv = _server(family, supervision="isolate", fault_plan=fp)
    params, states = _init(srv)
    st, outs, stats = srv.run_multi(params, states, _streams())
    base_st, base_outs = baseline[family]
    assert isinstance(stats.tenants["b"].error, InjectedFault)
    assert stats.tenants["b"].failed_site == site
    assert len(outs["b"]) < N_SNAP
    for sid in ("a", "c"):
        assert stats.tenants[sid].ok
        assert len(outs[sid]) == N_SNAP
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_array_equal(got, want)
        _assert_state_equal(st[sid], base_st[sid])
    _assert_matches_jax(st, outs, stats, _run_jax(
        family, supervision="isolate", fault_plan=jfp))
    _assert_no_serve_threads()


# ------------------------------------------------- retry + rollback ----


def test_transient_launch_fault_retried_evolvegcn(baseline):
    """A transient launch failure on EvolveGCN is survived by one retry
    from the rolled-back checkpoint: the final evolving weights equal the
    fault-free run exactly."""
    fp, jfp = _plans(dict(site="launch", index=0, count=1))
    kw = dict(supervision="isolate", max_retries=2, retry_backoff_ms=1.0)
    srv = _server("evolve", fault_plan=fp, **kw)
    params, states = _init(srv)
    st, outs, stats = srv.run_multi(params, states, _streams())
    base_st, base_outs = baseline["evolve"]
    assert not stats.tenant_errors
    assert stats.retries >= 1 and stats.rollbacks >= 1
    for sid in SIDS:
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_array_equal(got, want)
        _assert_state_equal(st[sid], base_st[sid])
    _assert_matches_jax(st, outs, stats,
                        _run_jax("evolve", fault_plan=jfp, **kw))


def test_midcommit_evolve_fault_rolls_back_partial_write(baseline):
    """An 'evolve'-site fault fires INSIDE the commit loop, after tenant
    'a''s state was already written: rollback must undo that partial
    commit so the replay serves every tenant exactly once. A checkpoint
    that did not hold the pre-launch state (a copy taken too late, or a
    reference to a tensor a launch wrote into) would leave 'a' evolved
    twice and fail here."""
    fp, jfp = _plans(dict(site="evolve", tenant="b", index=0, count=1))
    kw = dict(supervision="isolate", max_retries=1, retry_backoff_ms=1.0)
    srv = _server("evolve", fault_plan=fp, **kw)
    params, states = _init(srv)
    st, outs, stats = srv.run_multi(params, states, _streams())
    base_st, base_outs = baseline["evolve"]
    assert not stats.tenant_errors
    assert stats.rollbacks >= 1
    for sid in SIDS:
        assert len(outs[sid]) == N_SNAP
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_array_equal(got, want)
        _assert_state_equal(st[sid], base_st[sid])
    _assert_matches_jax(st, outs, stats,
                        _run_jax("evolve", fault_plan=jfp, **kw))


def test_midcommit_rollback_without_a_checkpoint_double_evolves(baseline):
    """The rollback test above has teeth: with a checkpoint that keeps
    nothing (rollback a no-op), the same fault leaves tenant 'a' evolved
    by the failed commit and again by the replay."""
    fp, _ = _plans(dict(site="evolve", tenant="b", index=0, count=1))
    srv = _server("evolve", supervision="isolate", max_retries=1,
                  retry_backoff_ms=1.0, fault_plan=fp)
    params, states = _init(srv)
    broken = TenantSupervisor
    srv._supervisor = lambda sids, outputs: type(
        "NoCheckpoint", (broken,), {"checkpoint": lambda self, s, ids: {}})(
        sids, srv._policy, outputs=outputs)
    st, _, _ = srv.run_multi(params, states, _streams())
    base_st, _ = baseline["evolve"]
    assert not all(torch.equal(x, y) for x, y in
                   zip(_leaves(st["a"]), _leaves(base_st["a"])))


# ------------------------------------------------- degradation ladder ----


def test_degrade_to_solo_launches(baseline):
    """A fault scoped to BATCHED launches walks the ladder to solo
    launches: every tenant is still served, bit-identical."""
    fp, jfp = _plans(dict(site="launch", scope="batched", index=0,
                          count=99))
    kw = dict(supervision="isolate", degrade=True)
    srv = _server("gcrn", fault_plan=fp, **kw)
    params, states = _init(srv)
    st, outs, stats = srv.run_multi(params, states, _streams())
    base_st, base_outs = baseline["gcrn"]
    assert not stats.tenant_errors
    assert stats.degraded_launches >= len(SIDS)
    for sid in SIDS:
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_array_equal(got, want)
        _assert_state_equal(st[sid], base_st[sid])
    _assert_matches_jax(st, outs, stats,
                        _run_jax("gcrn", fault_plan=jfp, **kw))


def test_degrade_to_oracle(baseline):
    """A fault scoped to the KERNEL path (batched AND solo launches fail)
    degrades to the plain PyTorch oracle through the force-ref gate:
    results keep flowing, equal to the kernel path within float
    tolerance. (The JAX force-ref server never fires a kernel-scoped
    fault; its fault-free run is the cross-package reference.)"""
    fp, _ = _plans(dict(site="launch", scope="kernel", index=0, count=999))
    srv = _server("gcrn", supervision="isolate", degrade=True, fault_plan=fp)
    params, states = _init(srv)
    st, outs, stats = srv.run_multi(params, states, _streams())
    base_st, base_outs = baseline["gcrn"]
    assert not stats.tenant_errors
    assert stats.degraded_launches >= len(SIDS)
    # each round: the batched launch and every solo kernel launch fail,
    # then one oracle launch a tenant serves
    assert stats.launches == 2 * (1 + 2 * len(SIDS))
    for sid in SIDS:
        assert len(outs[sid]) == N_SNAP
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_allclose(got, want, atol=1e-5)
        for x, y in zip(_leaves(st[sid]), _leaves(base_st[sid])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)
    jst, jouts, _ = _run_jax("gcrn")
    for sid in SIDS:
        for got, want in zip(outs[sid], jouts[sid]):
            np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("error", [RuntimeError, OSError])
@pytest.mark.parametrize("supervision", ["isolate", "strict"])
def test_broken_kernel_is_never_served_by_the_oracle(monkeypatch, error,
                                                     supervision):
    """A kernel that fails to build, load or launch raises a plain error
    from its wrapper, not a ServeFault. With degrade=True the ladder tries
    the solo kernel launch and stops there: the oracle rung is never
    launched and no output is degraded. Under isolate every tenant is
    quarantined with the kernel's error; under strict that error
    propagates after a clean shutdown."""
    oracles, _, *rest = ops._STREAM_DISPATCH["gcrn"]

    def broken(batched, *args, **kwargs):
        raise error("the gcrn engine did not build")

    monkeypatch.setitem(ops._STREAM_DISPATCH, "gcrn",
                        (oracles, broken, *rest))
    routes = []
    prev = ops.set_fault_hook(
        lambda *, family, batched, force_ref: routes.append(force_ref))
    try:
        srv = _server("gcrn", supervision=supervision, degrade=True)
        params, states = _init(srv)
        if supervision == "strict":
            with pytest.raises(error, match="did not build"):
                srv.run_multi(params, states, _streams())
        else:
            _, outs, stats = srv.run_multi(params, states, _streams())
    finally:
        ops.set_fault_hook(prev)
    _assert_no_serve_threads()
    assert routes and True not in routes  # the oracle rung never launched
    if supervision == "strict":
        assert len(routes) == 2  # the batched launch, the first solo one
        return
    assert stats.degraded_launches == 0
    assert set(stats.tenant_errors) == set(SIDS)
    assert all(isinstance(e, error) for e in stats.tenant_errors.values())
    assert all(outs[sid] == [] for sid in SIDS)
    # one batched launch, then one solo kernel launch a tenant
    assert stats.launches == len(routes) == 1 + len(SIDS)


# ------------------------------------------------------- deadlines ----


def test_launch_timeout_discards_and_retries(baseline):
    """A delay injected into the SECOND launch (the first of each shape is
    exempt) trips the plan deadline: the overdue result is discarded,
    counted, and the chunk is replayed to completion."""
    fp, jfp = _plans(dict(site="launch", index=1, count=1, delay_ms=600.0))
    kw = dict(supervision="isolate", max_retries=3, retry_backoff_ms=1.0,
              launch_timeout_ms=300.0)
    srv = _server("gcrn", fault_plan=fp, **kw)
    params, states = _init(srv)
    st, outs, stats = srv.run_multi(params, states, _streams())
    base_st, base_outs = baseline["gcrn"]
    assert not stats.tenant_errors
    assert stats.timeouts >= 1
    assert stats.retries >= 1
    for sid in SIDS:
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_array_equal(got, want)
        _assert_state_equal(st[sid], base_st[sid])
    _assert_matches_jax(st, outs, stats,
                        _run_jax("gcrn", fault_plan=jfp, **kw))


# ---------------------------------------------- single-tenant + non-v3 ----


def test_run_isolate_returns_partial_outputs():
    """Single-tenant ``run`` under supervision="isolate": a mid-stream
    fault stops the stream, keeps the already-committed chunk, and records
    the error instead of raising."""
    srv = _server("gcrn")
    params, _ = _init(srv)
    state = srv.model.init_state(params, mode="v3")
    base_state, base_outs, _ = srv.run(params, state, _make_snaps(0))

    fp, _ = _plans(dict(site="preprocess", tenant="stream", index=2))
    srv_f = _server("gcrn", supervision="isolate", fault_plan=fp)
    state = srv_f.model.init_state(params, mode="v3")
    _, outs, stats = srv_f.run(params, state, _make_snaps(0))
    assert len(outs) == CHUNK  # first chunk committed before the fault
    assert isinstance(stats.tenants["stream"].error, InjectedFault)
    for got, want in zip(outs, base_outs[:CHUNK]):
        np.testing.assert_array_equal(got, want)
    _assert_no_serve_threads()


def test_run_multi_isolate_nonstream_mode():
    """The per-snapshot (non-v3) device loop honors the same isolation
    contract: a preprocess fault quarantines its tenant, survivors match
    the fault-free run bit for bit, and the JAX server's."""
    srv = _server("gcrn", level="o1")
    params, states = _init(srv)
    _, base_outs, base_stats = srv.run_multi(params, states, _streams())
    assert not base_stats.tenant_errors

    fp, jfp = _plans(dict(site="preprocess", tenant="b", index=2))
    srv_f = _server("gcrn", level="o1", supervision="isolate", fault_plan=fp)
    params, states = _init(srv_f)
    st, outs, stats = srv_f.run_multi(params, states, _streams())
    assert isinstance(stats.tenants["b"].error, InjectedFault)
    assert len(outs["b"]) < N_SNAP
    for sid in ("a", "c"):
        assert len(outs[sid]) == N_SNAP
        for got, want in zip(outs[sid], base_outs[sid]):
            np.testing.assert_array_equal(got, want)
    _assert_matches_jax(st, outs, stats, _run_jax(
        "gcrn", level="o1", supervision="isolate", fault_plan=jfp),
        sids=("a", "c"))
    _assert_no_serve_threads()


# ------------------------------------------------- shutdown hygiene ----


def test_shutdown_leaves_no_threads_on_strict_failure():
    """The strict path raises — but only AFTER a clean shutdown: no
    producer thread outlives run_multi."""
    fp, _ = _plans(dict(site="preprocess", tenant="b", index=0))
    srv = _server("gcrn", fault_plan=fp)  # supervision="strict" default
    params, states = _init(srv)
    with pytest.raises(InjectedFault):
        srv.run_multi(params, states, _streams())
    _assert_no_serve_threads()


class _NotATenantFault(Exception):
    """An error outside ``faults.SUPERVISED``."""


@pytest.mark.parametrize("where", ["launch", "producer", "solo launch"])
def test_unsupervised_error_propagates_after_clean_shutdown(where):
    """Even under supervision="isolate" with retries and the ladder on, an
    error outside ``SUPERVISED`` (a programming fault) is not a tenant's:
    it propagates out of run_multi / run, raised once, after every
    producer thread has exited."""
    assert not issubclass(_NotATenantFault, SUPERVISED)
    srv = _server("gcrn", supervision="isolate", max_retries=2,
                  retry_backoff_ms=0.0, degrade=True)
    params, states = _init(srv)
    calls = []
    streams = _streams()
    if where == "producer":
        def bad_stream(first=streams["b"][:1]):
            yield from first
            raise _NotATenantFault("stream iterator broke")
        streams["b"] = bad_stream()
    else:
        def boom(*a, **k):
            calls.append(1)
            raise _NotATenantFault("launch broke")
        srv._launch_ragged = boom
    with pytest.raises(_NotATenantFault):
        if where == "solo launch":
            srv.run(params, states["a"], streams["a"])
        else:
            srv.run_multi(params, states, streams)
    if where != "producer":
        assert len(calls) == 1  # not retried, not degraded
    _assert_no_serve_threads()


# --------------------------------------------- boundary validation ----


def _bad_snap(kind):
    src = np.asarray([1, 2]), np.asarray([3, 4])
    if kind == "shape":
        return COOSnapshot(src=np.asarray([1, 2]), dst=np.asarray([3]),
                           edge_feat=np.ones((2, 2), np.float32), t_index=0)
    if kind == "rows":
        return COOSnapshot(src=src[0], dst=src[1],
                           edge_feat=np.ones((3, 2), np.float32), t_index=0)
    if kind == "negative":
        return COOSnapshot(src=np.asarray([-1, 2]), dst=src[1],
                           edge_feat=np.ones((2, 2), np.float32), t_index=0)
    if kind == "range":
        return COOSnapshot(src=np.asarray([1, N_GLOBAL]), dst=src[1],
                           edge_feat=np.ones((2, 2), np.float32), t_index=0)
    if kind == "nan":
        ef = np.ones((2, 2), np.float32)
        ef[1, 0] = np.nan
        return COOSnapshot(src=src[0], dst=src[1], edge_feat=ef, t_index=0)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["shape", "rows", "negative", "range",
                                  "nan"])
def test_validate_snapshot_rejects(kind):
    from repro.serve import SnapshotValidationError as JError
    from repro.serve import validate_snapshot as jvalidate

    with pytest.raises(SnapshotValidationError) as ei:
        validate_snapshot(_bad_snap(kind), N_GLOBAL, tenant="t0")
    assert ei.value.tenant == "t0"
    assert ei.value.site == "preprocess"
    with pytest.raises(JError) as want:
        jvalidate(_bad_snap(kind), N_GLOBAL, tenant="t0")
    assert str(ei.value) == str(want.value)
    validate_snapshot(_make_snaps(0)[0], N_GLOBAL)  # a healthy one passes


def test_run_strict_raises_on_malformed_snapshot():
    srv = _server("gcrn")
    params, _ = _init(srv)
    state = srv.model.init_state(params, mode="v3")
    stream = _make_snaps(0)[:1] + [_bad_snap("negative")]
    with pytest.raises(SnapshotValidationError):
        srv.run(params, state, stream)
    _assert_no_serve_threads()


def test_run_multi_isolate_quarantines_malformed_tenant():
    srv = _server("gcrn", supervision="isolate")
    params, states = _init(srv)
    streams = _streams()
    streams["b"] = streams["b"][:1] + [_bad_snap("nan")]
    _, outs, stats = srv.run_multi(params, states, streams)
    err = stats.tenants["b"].error
    assert isinstance(err, SnapshotValidationError)
    assert err.tenant == "b"
    for sid in ("a", "c"):
        assert stats.tenants[sid].ok
        assert len(outs[sid]) == N_SNAP
    _assert_no_serve_threads()


# ------------------------------------------------ plan/spec validation ----


@pytest.mark.parametrize("kwargs", [
    dict(site="nope"), dict(site="launch", scope="nope"),
    dict(site="evolve", scope="batched"), dict(site="launch", count=0),
    dict(site="launch", index=-1), dict(site="launch", delay_ms=-1.0)])
def test_fault_spec_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as got:
        FaultSpec(**kwargs)
    with pytest.raises(ValueError) as want:
        JFaultSpec(**kwargs)
    assert str(got.value) == str(want.value)


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultPlan(specs=("not a spec",))
    with pytest.raises(ValueError):
        FaultPlan(seed="zero")
    fp = FaultPlan(specs=[FaultSpec(site="launch"), FaultSpec(site="bucket")])
    assert fp.sites() == frozenset({"launch", "bucket"})
    assert isinstance(fp.specs, tuple)


@pytest.mark.parametrize("kwargs", [
    dict(supervision="maybe"), dict(max_retries=-1),
    dict(retry_backoff_ms=-1.0), dict(launch_timeout_ms=0.0),
    dict(fault_plan="chaos please")])
def test_plan_validates_supervision_fields(kwargs):
    with pytest.raises(ValueError) as got:
        api.plan(FAMILIES["gcrn"], level="v3", **kwargs)
    with pytest.raises(ValueError) as want:
        japi.plan(JFAMILIES["gcrn"], level="v3", **kwargs)
    assert str(got.value) == str(want.value)
    # a JAX FaultPlan is not the port's
    with pytest.raises(ValueError, match="serve.faults.FaultPlan"):
        api.plan(FAMILIES["gcrn"], level="v3", fault_plan=JFaultPlan())


def test_fault_injector_counts_occurrences_as_in_jax():
    specs = (dict(site="launch", tenant="b", index=1, count=2),
             dict(site="launch", scope="batched", index=0),
             dict(site="launch", scope="kernel", index=0, count=3))
    fp, jfp = _plans(*specs)
    inj, jinj = fp.injector(), jfp.injector()
    probes = [(("b",), 1, False), (("a", "b"), 2, False), (("b",), 1, True),
              (("b",), 1, True), (("a", "c"), 2, True), (("b",), 1, False)]
    for tenants, n_live, force_ref in probes:
        fired = []
        for i in (inj, jinj):
            try:
                i.probe("launch", tenants=tenants, n_live=n_live,
                        force_ref=force_ref)
                fired.append(None)
            except RuntimeError as e:  # both packages' InjectedFault
                fired.append(str(e))
        assert fired[0] == fired[1], (tenants, n_live, force_ref)
    assert inj._counts == jinj._counts


# ------------------------------------------- calibration fallback ----


def test_measured_guard_calibration_failure_warns_and_falls_back():
    """The measured promotion guard must not die (or stay silent) when
    calibration fails: it warns, records the reason, and the static
    bucket_cost proxy takes over."""
    srv = _server("gcrn", promote_buckets=2.0, promotion_guard="measured")
    params, _ = _init(srv)

    def boom(*a, **k):
        raise RuntimeError("calibration kaboom")

    srv._launch_ragged = boom
    with pytest.warns(RuntimeWarning, match="falling back"):
        cost = srv._promotion_cost(params)
    assert cost is bucket_cost
    assert "kaboom" in srv._calib_error


# ----------------------------------- the port's reference checkpoint ----


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("force_ref", [False, True])
@pytest.mark.parametrize("residency", ["vmem", "hbm_paged"])
def test_a_launch_leaves_its_input_states_unchanged(family, force_ref,
                                                    residency):
    """The reference checkpoint is complete only if no launch writes into
    a tenant's state tensors: a staged group's launch (the kernel
    wrapper's route, on the CPU its plain version, and the force-ref
    route; resident and paged) leaves every member's input state bit for
    bit as it was, and hands back new tensors."""
    kw = (dict(state_residency="hbm_paged", td=8, buffer_depth=2)
          if residency == "hbm_paged" else {})
    srv = _server(family, **kw)
    params, states = _init(srv)
    # states that have served a chunk already, so they are not all zeros
    states, _, _ = srv.run_multi(params, states, {
        sid: _make_snaps(10 + i, n_snap=2) for i, sid in enumerate(SIDS)})
    before = {sid: map_state(torch.clone, states[sid]) for sid in SIDS}
    held = {sid: _leaves(states[sid]) for sid in SIDS}
    group = [(sid, [srv._preprocess(s, sid)
                     for s in _make_snaps(20 + i, n_snap=CHUNK)],
              BUCKETS[0]) for i, sid in enumerate(SIDS)]
    staged, _, _, _, _ = srv._stage_group(params, states, group,
                                          force_ref=force_ref)
    for sid in SIDS:
        _assert_state_equal(states[sid], before[sid])
        for a, b in zip(_leaves(staged[sid]), held[sid]):
            assert a.data_ptr() != b.data_ptr()
    # and the checkpoint is the tenant's own tensors
    sup = TenantSupervisor(SIDS, SupervisionPolicy())
    ckpt = sup.checkpoint(states, SIDS)
    assert all(ckpt[sid] is states[sid] for sid in SIDS)


def test_evict_and_recover_round_trip_bit_for_bit():
    srv = _server("evolve")
    params, states = _init(srv)
    sup = TenantSupervisor(SIDS, SupervisionPolicy(), device="cpu")
    want = map_state(torch.clone, states["a"])
    page = sup.evict_to_host(states, "a")
    assert "a" not in states
    assert all(isinstance(x, np.ndarray) for x in _leaves(page))
    sup.recover_from_host(states, "a", page)
    _assert_state_equal(states["a"], want)
    assert all(x.device.type == "cpu" for x in _leaves(states["a"]))
    assert (sup.results["a"].evictions, sup.results["a"].recoveries) == (1, 1)


# ---------------------------------------------- the launch-site hook ----


@pytest.mark.parametrize("force_ref", [False, True])
def test_fault_hook_fires_once_a_launch_on_both_routes(force_ref):
    """ops calls the installed hook once before each stream-engine launch,
    with the route's force_ref, and not at all once it is cleared."""
    import harness

    args, _, _ = harness.stream_kernel_case("gcrn", seed=0)
    seen = []
    prev = ops.set_fault_hook(lambda **kw: seen.append(kw))
    try:
        ops.stream_steps("gcrn", *args, force_ref=force_ref, device="cpu")
        ops.stream_steps_batched("gcrn", *[a[None] for a in args[:8]],
                                 *args[8:], force_ref=force_ref,
                                 device="cpu")
    finally:
        assert ops.set_fault_hook(prev) is not None
    assert seen == [dict(family="gcrn", batched=False, force_ref=force_ref),
                    dict(family="gcrn", batched=True, force_ref=force_ref)]
    ops.stream_steps("gcrn", *args, force_ref=force_ref, device="cpu")
    assert len(seen) == 2


def test_a_raising_hook_fails_the_launch_before_it_runs():
    import harness

    args, _, _ = harness.stream_kernel_case("gcrn", seed=0)

    def hook(**kw):
        raise InjectedFault("boom", tenant="x", site="launch")

    prev = ops.set_fault_hook(hook)
    try:
        with pytest.raises(InjectedFault, match="boom"):
            ops.stream_steps("gcrn", *args, device="cpu")
    finally:
        ops.set_fault_hook(prev)


def test_fault_injector_counts_are_exact_under_thread_contention():
    """Producer threads and the device loop probe one injector at once:
    with more threads than cores and a tiny switch interval, every probe
    is counted once and exactly ``count`` faults fire."""
    import sys

    fp, _ = _plans(dict(site="preprocess", index=100, count=37))
    inj = fp.injector()
    n_threads, n_probes = 4 * (os.cpu_count() or 1) + 1, 200
    fired = []
    lock = threading.Lock()

    def worker(i):
        for _ in range(n_probes):
            try:
                inj.probe("preprocess", tenants=(f"t{i}",))
            except InjectedFault as e:
                with lock:
                    fired.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert inj._counts == [n_threads * n_probes]
    assert len(fired) == 37
