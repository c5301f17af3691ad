"""Session-level parity of the port with the JAX package, and the plan API.

``repro_torch.api.BoosterSession(cfg, plan(cfg, level="v3"),
device="cpu")`` runs GCRN-M2, EvolveGCN-O and the stacked GCN -> GRU on
the harness's random
ragged streams (``harness.make_case``, T = 5, B = 3) with the JAX model's
parameters carried across (``params_from_jax``). Its outputs and final
states (h / c stores; evolved weights) must match the JAX session's, solo
and ragged-batched, unblocked and D-blocked (``stream_td=16``), at the
harness's tolerance 3e-4.

The JAX session runs under ``ops.set_force_ref(True)``: its Pallas
interpret path does not build with the installed jax (see
tests/test_torch_stream.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import harness
from repro import api as japi
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.params import params_from_jax, state_from_jax

ATOL = 3e-4
MODELS = ("gcrn-m2", "evolvegcn", "stacked-gcn-gru")
LENS = (5, 3, 4)


@pytest.fixture
def jax_oracle():
    jops.set_force_ref(True)
    yield
    jops.set_force_ref(False)


def _port_cfg(cfg) -> DGNNConfig:
    return DGNNConfig(**dataclasses.asdict(cfg))


def _port_snaps(s) -> PaddedSnapshot:
    return PaddedSnapshot(**{f.name: np.asarray(getattr(s, f.name))
                             for f in dataclasses.fields(PaddedSnapshot)})


def _head(s, t):
    return jax.tree.map(lambda a: np.asarray(a)[:t], s)


def _sessions(case):
    jsess = japi.BoosterSession(case.cfg, japi.plan(case.cfg, level="v3"),
                                n_global=case.n_global, params=case.params)
    cfg = _port_cfg(case.cfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, case.params))
    tsess = tapi.BoosterSession(cfg, tapi.plan(cfg, level="v3"),
                                n_global=case.n_global, params=params,
                                device="cpu")
    return jsess, tsess


def _assert_state_close(port, ref, label):
    ref = jax.tree.map(np.asarray, ref)
    assert set(port) == set(ref), label
    if "weights" in ref:
        assert len(port["weights"]) == len(ref["weights"])
        pairs = list(zip(port["weights"], ref["weights"]))
    else:
        pairs = [(port[k], ref[k]) for k in sorted(ref)]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL,
                                   err_msg=f"{label} state[{i}]")


@pytest.mark.parametrize("td", [None, 16])
@pytest.mark.parametrize("name", MODELS)
def test_session_run_matches_jax(jax_oracle, name, td):
    case = harness.make_case(name, T=5, B=3, stream_td=td)
    jsess, tsess = _sessions(case)
    assert tsess.plan.td == td
    _assert_state_close(tsess.state, jsess.state, f"{name} primed")
    for chunk in (case.stacked[0], case.stacked[1]):  # state carries over
        want = np.asarray(jsess.run(chunk))
        got = tsess.run(_port_snaps(chunk)).numpy()
        assert np.isfinite(want).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
    _assert_state_close(tsess.state, jsess.state, f"{name} run")


@pytest.mark.parametrize("td", [None, 16])
@pytest.mark.parametrize("name", MODELS)
def test_session_run_batched_ragged_matches_jax(jax_oracle, name, td):
    case = harness.make_case(name, T=5, B=3, stream_td=td)
    jsess, tsess = _sessions(case)
    streams = [_head(s, t) for s, t in zip(case.stacked, LENS)]
    jstates, jouts = jsess.run_batched(streams)
    tstates, touts = tsess.run_batched([_port_snaps(s) for s in streams])
    for b, (g, w) in enumerate(zip(touts, jouts)):
        assert g.shape[0] == LENS[b]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=f"{name} row {b}")
    _assert_state_close(tstates, jstates, f"{name} batched")


@pytest.mark.parametrize("force_ref", [False, True])
def test_evolve_edge_terms_on_the_cpu_are_the_jax_terms(force_ref):
    """EvolveGCN-O's edge terms on the CPU, with force_ref or without, take
    the torch ops (the edge-term kernel is not launched), written in the
    square layout (..., L, n, dmax), and agree with the JAX package's
    per-layer terms, which project the edge features before the gather
    (so within ATOL, not bit for bit)."""
    from repro_torch.kernels import engine

    case = harness.make_case("evolvegcn", T=5, B=3)
    assert case.cfg.edge_dim
    jsess, tsess = _sessions(case)
    engine.reset_launches()
    for chunk in case.stacked:
        want = jsess.model._edge_aggs(jsess.params, chunk)
        got = tsess.model._edge_aggs(tsess.params,
                                     _port_snaps(chunk).to("cpu"),
                                     force_ref=force_ref)
        assert got.shape[-3] == len(want)
        for l, w in enumerate(want):
            din = w.shape[-1]
            np.testing.assert_allclose(got[..., l, :, :din].numpy(),
                                       np.asarray(w), atol=ATOL)
            assert not got[..., l, :, din:].any()
    assert engine.LAUNCHES["edge_terms"] == 0


def test_state_from_jax_continues_a_stream(jax_oracle):
    case = harness.make_case("gcrn-m2", T=5, B=1)
    jsess, tsess = _sessions(case)
    jsess.run(case.stacked[0])
    tsess.state = state_from_jax(tsess.cfg,
                                 jax.tree.map(np.asarray, jsess.state))
    want = np.asarray(jsess.run(case.stacked[0]))
    got = tsess.run(_port_snaps(case.stacked[0])).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_params_from_jax_checks_layout():
    case = harness.make_case("evolvegcn", T=2, B=1)
    cfg = _port_cfg(case.cfg)
    params = jax.tree.map(np.asarray, case.params)
    params["gcn"][0]["w"] = params["gcn"][0]["w"][:, :3]
    with pytest.raises(ValueError, match=r"gcn\[0\]\.w: shape"):
        params_from_jax(cfg, params)
    with pytest.raises(ValueError, match="expected keys"):
        params_from_jax(cfg, {"gcn": []})


# ------------------------------------------------------------ plans ----

@pytest.mark.parametrize("kwargs", [
    dict(family="gat"),
    dict(family="gcrn", level="v1"),
    dict(family="evolve", level="v2"),
    dict(family="gcrn", tn=0),
    dict(family="gcrn", tn=12),
    dict(family="gcrn", td=12),
    dict(family="gcrn", batch=0),
    dict(family="gcrn", batch=2, lengths=(3,)),
    dict(family="gcrn", batch=2, lengths=(0, 0)),
    dict(family="gcrn", level="o1", lengths=(3,)),
    dict(family="gcrn", temporal="event"),
    dict(family="gcrn", state_residency="hbm_paged"),
    dict(family="gcrn", buffer_depth=2),
    dict(family="gcrn", state_residency="hbm_paged", td=8, buffer_depth=3),
    dict(family="static_gcn", state_residency="hbm_paged", td=8),
    dict(family="gcrn", scheduler="continuous", level="o1"),
    dict(family="gcrn", prefill_chunk=2),
    dict(family="gcrn", promote_buckets=2.0),
    dict(family="gcrn", supervision="loose"),
])
def test_plan_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as want:
        japi.plan(**kwargs)
    with pytest.raises(ValueError) as got:
        tapi.plan(**kwargs)
    assert str(got.value) == str(want.value)


def _assert_paged_session_runs(case, plan_kwargs):
    """hbm_paged residency is ported: the paged plan runs
    on the CPU and matches the resident session (1e-6) and the JAX
    session (3e-4), on the JAX model's parameters."""
    jops.set_force_ref(True)
    try:
        jsess, resident = _sessions(case)
        want = np.asarray(jsess.run(case.stacked[0]))
    finally:
        jops.set_force_ref(False)
    paged = tapi.BoosterSession(resident.cfg,
                                tapi.plan(resident.cfg, **plan_kwargs),
                                n_global=case.n_global,
                                params=resident.params, device="cpu")
    got = paged.run(_port_snaps(case.stacked[0])).numpy()
    base = resident.run(_port_snaps(case.stacked[0])).numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, base, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for k in ("h", "c"):
        np.testing.assert_allclose(paged.state[k].numpy(),
                                   resident.state[k].numpy(), atol=1e-6,
                                   rtol=0)


def _serve_snaps(cfg, n_global, T=3, seed=0):
    """T random COO snapshots over ``n_global`` nodes and a feature
    table for them."""
    from repro_torch.graph.coo import COOSnapshot

    rng = np.random.default_rng(seed)
    ft = rng.normal(size=(n_global, cfg.in_dim)).astype(np.float32)
    snaps = [COOSnapshot(src=rng.integers(0, n_global, 6),
                         dst=rng.integers(0, n_global, 6),
                         edge_feat=rng.normal(size=(6, cfg.edge_dim)).astype(
                             np.float32), t_index=t) for t in range(T)]
    return ft, snaps


# The ids are the ones these cases had while the serve layer was unported
# (their match strings then), kept so each case keeps its name.
@pytest.mark.parametrize("kwargs,match", [
    pytest.param(dict(level="o1", stream_chunk=4), "serves",
                 id="kwargs0-stream_chunk=4: .*the serve layer"),
    # hbm_paged is ported: this plan executes and serves (match None)
    pytest.param(dict(level="v3", state_residency="hbm_paged", td=8), None,
                 id="kwargs1-item 11"),
    # the continuous scheduler is ported: this plan runs and serves
    pytest.param(dict(scheduler="continuous", level="v3"), "serves",
                 id="kwargs2-scheduler='continuous': .*the serve layer"),
    pytest.param(dict(max_retries=2, level="v3"), "serves",
                 id="kwargs3-max_retries=2: .*the serve layer"),
    pytest.param(dict(n_pad=256, level="v3"), "serves",
                 id="kwargs4-n_pad=256: .*the serve layer"),
])
def test_unported_plan_fields_raise_on_execution(kwargs, match):
    """The serve layer is ported: a plan's serve-policy fields steer
    ``serve`` and are ignored by ``run`` (as in the JAX package), so such
    a plan runs, equal to the plan without them, and serves. The
    continuous scheduler's fields too: ``serve`` ignores them, as the JAX
    package's does, and ``serve_multi`` runs ticks."""
    case = harness.make_case("gcrn-m2", T=2, B=1)
    cfg = _port_cfg(case.cfg)
    p = tapi.plan(cfg, **kwargs)
    ft, snaps = _serve_snaps(cfg, case.n_global)
    sess = tapi.BoosterSession(cfg, p, n_global=case.n_global,
                               feat_table=ft,
                               gen=torch.Generator().manual_seed(0),
                               device="cpu")
    if match is None:
        _assert_paged_session_runs(case, kwargs)
    elif match == "serves":
        bare = dict(kwargs)
        for name in ("stream_chunk", "max_retries", "n_pad", "scheduler"):
            bare.pop(name, None)
        plain = tapi.BoosterSession(cfg, tapi.plan(cfg, **bare),
                                    n_global=case.n_global,
                                    params=sess.params, device="cpu")
        snaps_T = _port_snaps(case.stacked[0])
        np.testing.assert_array_equal(sess.run(snaps_T).numpy(),
                                      plain.run(snaps_T).numpy())
    sess.reset_state()
    outs, stats = sess.serve(snaps)
    assert len(outs) == len(snaps)
    assert all(o.shape == (p.n_pad, cfg.out_dim) and np.isfinite(o).all()
               for o in outs)
    assert stats.launches == (0 if p.level != "v3" else 1)
    assert stats.degraded_launches == 0
    assert stats.ticks == 0
    if p.scheduler == "continuous":
        _, multi, stats = sess.serve_multi({"a": snaps, "b": snaps[1:]})
        assert stats.ticks > 0 and stats.degraded_launches == 0
        for a, b in zip(multi["a"], outs):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
