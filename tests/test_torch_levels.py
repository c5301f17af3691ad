"""Every dataflow level of the port computes the JAX package's function.

For GCRN-M2, EvolveGCN-O and the stacked GCN -> GRU, every level of
``FAMILY_LEVELS`` runs in ``repro_torch`` on the CPU (the kernel wrappers'
plain versions) and must match the JAX package at the same level on the
harness's random streams (``harness.make_case``, T = 4, B = 3), with the JAX
parameters carried across (``params_from_jax``): outputs and final states,
for ``BoosterSession.run`` (two chunks, so the state carries over) and
equal-T ``run_batched``, and for ``build_model(cfg, impl="pallas")`` with
``run_plan`` (the ELL SpMM path). Tolerance 3e-4, the harness's own.

The JAX side runs its Pallas kernels in interpret mode (the V2 fused steps
and the ELL SpMM build there); only its stream engine does not, so level
v3 is covered by tests/test_torch_session.py against its oracle. Inside the
port every level must match its own baseline, as tests/test_dgnn_core.py
asserts for the JAX package.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import harness
from repro import api as japi
from repro.core import dataflow as jdataflow
from repro_torch import api as tapi
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import dataflow as tdataflow
from repro_torch.core import rnn as trnn
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.params import params_from_jax

ATOL = 3e-4
MODELS = ("gcrn-m2", "evolvegcn", "stacked-gcn-gru")
PER_STEP = [(name, level) for name in MODELS
            for level in tapi.FAMILY_LEVELS[
                tapi.family_for(harness.small_config(name))]
            if level != "v3"]
IDS = [f"{n}-{l}" for n, l in PER_STEP]


def _port_cfg(cfg) -> DGNNConfig:
    return DGNNConfig(**dataclasses.asdict(cfg))


def _port_snaps(s) -> PaddedSnapshot:
    return PaddedSnapshot(**{f.name: np.asarray(getattr(s, f.name))
                             for f in dataclasses.fields(PaddedSnapshot)})


def _port_params(case, cfg=None, params=None):
    cfg = cfg or _port_cfg(case.cfg)
    params = case.params if params is None else params
    return cfg, params_from_jax(cfg, jax.tree.map(np.asarray, params))


def _assert_close(got, want, label):
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 0, label
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=label)


def _assert_states_close(port, ref, label):
    ref = jax.tree.map(np.asarray, ref)
    assert set(port) == set(ref), label
    for k in sorted(ref):
        pv = port[k] if isinstance(port[k], list) else [port[k]]
        rv = ref[k] if isinstance(ref[k], list) else [ref[k]]
        assert len(pv) == len(rv), label
        for i, (a, b) in enumerate(zip(pv, rv)):
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL,
                                       err_msg=f"{label} {k}[{i}]")


@pytest.mark.parametrize("name,level", PER_STEP, ids=IDS)
def test_session_run_matches_jax(name, level):
    case = harness.make_case(name, T=4, B=1)
    cfg, params = _port_params(case)
    jsess = japi.BoosterSession(case.cfg, japi.plan(case.cfg, level=level),
                                n_global=case.n_global, params=case.params)
    tsess = tapi.BoosterSession(cfg, tapi.plan(cfg, level=level),
                                n_global=case.n_global, params=params,
                                device="cpu")
    _assert_states_close(tsess.state, jsess.state, f"{name} {level} init")
    for chunk in (case.stacked[0], case.stacked[0]):  # state carries over
        _assert_close(tsess.run(_port_snaps(chunk)), jsess.run(chunk),
                      f"{name} {level} run")
    _assert_states_close(tsess.state, jsess.state, f"{name} {level} run")


@pytest.mark.parametrize("name,level", PER_STEP, ids=IDS)
def test_session_run_batched_matches_jax(name, level):
    case = harness.make_case(name, T=4, B=3)
    cfg, params = _port_params(case)
    jsess = japi.BoosterSession(case.cfg, japi.plan(case.cfg, level=level),
                                n_global=case.n_global, params=case.params)
    tsess = tapi.BoosterSession(cfg, tapi.plan(cfg, level=level),
                                n_global=case.n_global, params=params,
                                device="cpu")
    jstates, jouts = jsess.run_batched(case.stacked)
    tstates, touts = tsess.run_batched([_port_snaps(s) for s in case.stacked])
    for b, (g, w) in enumerate(zip(touts, jouts)):
        _assert_close(g, w, f"{name} {level} row {b}")
    _assert_states_close(tstates, jstates, f"{name} {level} batched")


@pytest.mark.parametrize("name,level", PER_STEP, ids=IDS)
def test_impl_pallas_matches_jax(name, level):
    """``impl="pallas"``: the message passing of every GCN goes through the
    ELL SpMM, the JAX package's Pallas kernel in interpret mode."""
    case = harness.make_case(name, T=3, B=1)
    cfg, params = _port_params(case)
    jmodel = jdataflow.build_model(case.cfg, impl="pallas",
                                   n_global=case.n_global)
    tmodel = tdataflow.build_model(cfg, impl="pallas",
                                   n_global=case.n_global)
    jplan, tplan = japi.plan(case.cfg, level=level), tapi.plan(cfg, level=level)
    jstate, jout = jdataflow.run_plan(
        jmodel, case.params, jmodel.init_state(case.params, mode=level),
        case.stacked[0], jplan)
    tstate, tout = tdataflow.run_plan(
        tmodel, params, tmodel.init_state(params, mode=level),
        _port_snaps(case.stacked[0]).to("cpu"), tplan)
    _assert_close(tout, jout, f"{name} {level} pallas")
    _assert_states_close(tstate, jstate, f"{name} {level} pallas")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", MODELS)
def test_every_level_matches_the_ports_baseline(name, impl):
    """The paper's contract inside the port: every level, v3 included,
    gives baseline's outputs and final state; EvolveGCN's primed levels
    (v1, v3) carry exactly one evolution more than the unprimed ones."""
    case = harness.make_case(name, seed=5, T=4, B=1)
    cfg, params = _port_params(case)
    model = tdataflow.build_model(cfg, impl=impl, n_global=case.n_global)
    snaps = _port_snaps(case.stacked[0]).to("cpu")
    runs = {}
    for level in tapi.FAMILY_LEVELS[tapi.family_for(cfg)]:
        state0 = model.init_state(params, mode=level)
        runs[level] = tdataflow.run_plan(model, params, state0, snaps,
                                         tapi.plan(cfg, level=level))
    base_state, base = runs["baseline"]
    assert torch.isfinite(base).all() and base.abs().max() > 0
    for level, (state, out) in runs.items():
        np.testing.assert_allclose(out.numpy(), base.numpy(), atol=ATOL,
                                   err_msg=f"{name} {level}")
        want = base_state
        if level in ("v1", "v3") and "weights" in state:
            want = {"weights": [trnn.matrix_gru(g, w) for g, w in
                                zip(params["gru"], base_state["weights"])]}
        _assert_states_close(state, jax.tree.map(np.asarray, want),
                             f"{name} {level} state")


@pytest.mark.parametrize("level", ["baseline", "v1", "v2", "v3"])
def test_one_layer_stacked_matches_jax(level):
    """With one GCN layer the fused layer is layer 0, so the V2 step kernel
    and the stream engine take the projected edge messages (their edge
    variant); with the config's two layers they take none."""
    from repro.kernels import ops as jops

    case = harness.make_case("stacked-gcn-gru", seed=2, T=4, B=3)
    jcfg = dataclasses.replace(case.cfg, n_gnn_layers=1)
    jparams = jdataflow.build_model(jcfg, n_global=case.n_global).init(
        jax.random.PRNGKey(7))
    assert "w_edge" in jparams["gcn"][0]
    cfg, params = _port_params(case, _port_cfg(jcfg), jparams)
    jops.set_force_ref(level == "v3")  # the interpret stream engine fails
    try:
        jsess = japi.BoosterSession(jcfg, japi.plan(jcfg, level=level),
                                    n_global=case.n_global, params=jparams)
        want = jsess.run(case.stacked[0])
        jstates, jouts = jsess.run_batched(case.stacked)
    finally:
        jops.set_force_ref(False)
    tsess = tapi.BoosterSession(cfg, tapi.plan(cfg, level=level),
                                n_global=case.n_global, params=params,
                                device="cpu")
    _assert_close(tsess.run(_port_snaps(case.stacked[0])), want,
                  f"1-layer {level} run")
    _assert_states_close(tsess.state, jsess.state, f"1-layer {level}")
    tstates, touts = tsess.run_batched([_port_snaps(s) for s in case.stacked])
    for b, (g, w) in enumerate(zip(touts, jouts)):
        _assert_close(g, w, f"1-layer {level} row {b}")
    _assert_states_close(tstates, jstates, f"1-layer {level} batched")


@pytest.mark.parametrize("name", MODELS)
def test_default_plan_session_runs(name):
    """``BoosterSession(cfg, gen=...)`` with the config's own level (GCRN-M2
    v2, EvolveGCN-O v1, stacked v1) runs; no level of the three families
    raises."""
    case = harness.make_case(name, T=3, B=1)
    cfg = _port_cfg(case.cfg)
    sess = tapi.BoosterSession(cfg, n_global=case.n_global,
                               gen=torch.Generator().manual_seed(0),
                               device="cpu")
    assert sess.plan.level == cfg.dataflow
    out = sess.run(_port_snaps(case.stacked[0]))
    assert out.shape[0] == 3 and torch.isfinite(out).all()


def test_ragged_batch_at_a_per_step_level_raises():
    case = harness.make_case("gcrn-m2", T=4, B=2)
    cfg, params = _port_params(case)
    sess = tapi.BoosterSession(cfg, tapi.plan(cfg, level="o1"),
                               n_global=case.n_global, params=params,
                               device="cpu")
    head = jax.tree.map(lambda a: np.asarray(a)[:2], case.stacked[1])
    with pytest.raises(ValueError, match="stream-engine"):
        sess.run_batched([_port_snaps(case.stacked[0]), _port_snaps(head)])


@pytest.mark.parametrize("level", ["baseline", "v2"])
def test_renumber_past_the_store_raises_at_per_step_levels(level):
    case = harness.make_case("gcrn-m2", T=2, B=1)
    cfg, params = _port_params(case)
    sess = tapi.BoosterSession(cfg, tapi.plan(cfg, level=level),
                               n_global=case.n_global, params=params,
                               device="cpu")
    snaps = _port_snaps(case.stacked[0])
    snaps.renumber = np.array(snaps.renumber)
    snaps.renumber[1, 0] = case.n_global
    with pytest.raises(ValueError, match="past the store"):
        sess.run(snaps)
