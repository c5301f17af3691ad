"""The port's per-step kernels and the plumbing around them.

* ``repro_torch.kernels.ops`` ``ell_spmm`` (with and without edge messages,
  with a leading batch axis), ``dgnn_fused_step`` and ``stacked_fused_step``
  on the CPU (the kernel wrappers' plain versions, and the force-ref path)
  against the JAX package's ops of the same name running their Pallas
  kernels in interpret mode, on the same numpy inputs, at a node count that
  is no multiple of the JAX node tile. Tolerance 3e-4, the harness's own.
* ``init_state`` / ``init_states_batched`` default to level "baseline", as
  in the JAX package; ``api.run_arrays`` takes the stream engine whatever
  the plan's level; the stacked layout through ``params_from_jax`` /
  ``state_from_jax``.
* The new kernel wrappers refuse devices other than cpu and cuda; on a
  card they match their plain versions (skipped here).
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
from repro_torch.core import dataflow as tdataflow
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops
from repro_torch.params import params_from_jax, state_from_jax

ATOL = 3e-4


def _inputs(seed, n=37, k=5, din=12, dmid=16, h=24, e=50):
    """Random per-step inputs: padding rows past n_real (coef 0), lanes
    that reference real rows only, some coef-0 lanes."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    n_real = n - 6
    idx = rng.integers(0, n_real, (n, k)).astype(np.int32)
    coef = (rng.uniform(size=(n, k)) * (rng.uniform(size=(n, k)) > 0.3)
            ).astype(np.float32)
    coef[n_real:] = 0.0
    return dict(idx=idx, coef=coef,
                eidx=rng.integers(0, e, (n, k)).astype(np.int32),
                x=f32(n, din), xh=f32(n, h), h=f32(n, h), c=f32(n, h),
                em=f32(e, din), wx=f32(din, 4 * h), wh=f32(h, 4 * h),
                b=f32(4 * h), wg=f32(din, dmid), bg=f32(dmid),
                gx=f32(dmid, 3 * h), gh=f32(h, 3 * h), gb=f32(3 * h))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(got, want, label):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (label, i)
        assert np.isfinite(w).all() and np.abs(w).max() > 0, label
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                   err_msg=f"{label}[{i}]")


@pytest.mark.parametrize("force_ref", [False, True])
@pytest.mark.parametrize("edges", [False, True])
def test_ell_spmm_matches_jax_pallas(edges, force_ref):
    d = _inputs(1)
    em = d["em"] if edges else None
    want = jops.ell_spmm(d["idx"], d["coef"], d["eidx"], d["x"], em, tn=16)
    got = tops.ell_spmm(*_t(d["idx"], d["coef"], d["eidx"], d["x"], em),
                        force_ref=force_ref)
    _close(got, want, f"ell_spmm edges={edges}")


@pytest.mark.parametrize("edges", [False, True])
def test_ell_spmm_leading_axes_are_independent_graphs(edges):
    """One call over (B, T) graphs equals one JAX call per graph (the
    stacked stream path aggregates its earlier layers this way)."""
    per = [_inputs(10 + i) for i in range(6)]
    stack = lambda key: np.stack([p[key] for p in per]).reshape(
        2, 3, *per[0][key].shape)
    em = stack("em") if edges else None
    got = tops.ell_spmm(*_t(stack("idx"), stack("coef"), stack("eidx"),
                            stack("x"), em))
    assert got.shape == (2, 3, *per[0]["x"].shape)
    for i, p in enumerate(per):
        want = jops.ell_spmm(p["idx"], p["coef"], p["eidx"], p["x"],
                             p["em"] if edges else None, tn=16)
        _close(got.reshape(6, *got.shape[2:])[i], want, f"graph {i}")


@pytest.mark.parametrize("force_ref", [False, True])
@pytest.mark.parametrize("edges", [False, True])
def test_dgnn_fused_step_matches_jax_pallas(edges, force_ref):
    d = _inputs(2)
    em = d["em"] if edges else None
    args = (d["idx"], d["coef"], d["eidx"], d["x"], d["xh"], d["c"],
            d["wx"], d["wh"], d["b"], em)
    want = jops.dgnn_fused_step(*args, tn=16)
    got = tops.dgnn_fused_step(*_t(*args), force_ref=force_ref)
    _close(got, want, f"dgnn_fused_step edges={edges}")


@pytest.mark.parametrize("force_ref", [False, True])
@pytest.mark.parametrize("edges", [False, True])
def test_stacked_fused_step_matches_jax_pallas(edges, force_ref):
    d = _inputs(3)
    em = d["em"] if edges else None
    args = (d["idx"], d["coef"], d["eidx"], d["x"], d["h"], d["wg"],
            d["bg"], d["gx"], d["gh"], d["gb"], em)
    want = jops.stacked_fused_step(*args, tn=16)
    got = tops.stacked_fused_step(*_t(*args), force_ref=force_ref)
    _close(got, want, f"stacked_fused_step edges={edges}")


# ------------------------------------------------------------ repairs ----

def _port_cfg(cfg) -> DGNNConfig:
    return DGNNConfig(**dataclasses.asdict(cfg))


def _case_params(name):
    case = harness.make_case(name, T=3, B=2)
    cfg = _port_cfg(case.cfg)
    return case, cfg, params_from_jax(cfg, jax.tree.map(np.asarray,
                                                        case.params))


@pytest.mark.parametrize("name", ["gcrn-m2", "evolvegcn", "stacked-gcn-gru"])
def test_init_state_defaults_to_baseline_as_in_jax(name):
    """With no mode, the state is baseline's (EvolveGCN: unprimed weights),
    as in the JAX package, for ``init_state`` and ``init_states_batched``."""
    from repro.core import dataflow as jdataflow

    case, cfg, params = _case_params(name)
    tmodel = tdataflow.build_model(cfg, n_global=case.n_global)
    want = case.model.init_state(case.params)
    got = tmodel.init_state(params)
    wantB = jdataflow.init_states_batched(case.model, case.params, 2)
    gotB = tdataflow.init_states_batched(tmodel, params, 2)
    for port, ref in ((got, want), (gotB, wantB)):
        assert set(port) == set(ref)
        for k in ref:
            pv = port[k] if isinstance(port[k], list) else [port[k]]
            rv = ref[k] if isinstance(ref[k], list) else [ref[k]]
            for a, b in zip(pv, rv):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-6, err_msg=f"{name} {k}")
    if name == "evolvegcn":
        np.testing.assert_array_equal(got["weights"][0].numpy(),
                                      params["gcn"][0]["w"].numpy())


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("level", ["baseline", "o1", "v2"])
def test_run_arrays_takes_the_stream_engine_at_any_level(level, batched):
    args, _, _ = harness.stream_kernel_case("gcrn", seed=8,
                                            B=2 if batched else None)
    batch = dict(batch=2) if batched else {}
    want = japi.run_arrays(japi.plan(family="gcrn", level=level, tn=32,
                                     **batch), *args, force_ref=True)
    got = tapi.run_arrays(tapi.plan(family="gcrn", level=level, tn=32,
                                    **batch), *args, device="cpu")
    _close(got, want, f"run_arrays {level}")


def test_stacked_params_and_state_from_jax_continue_a_stream():
    jops.set_force_ref(True)
    try:
        case, cfg, params = _case_params("stacked-gcn-gru")
        assert set(params) == {"gcn", "gru"}
        assert "w_edge" in params["gcn"][0]
        assert "w_edge" not in params["gcn"][1]
        jsess = japi.BoosterSession(case.cfg, japi.plan(case.cfg),
                                    n_global=case.n_global,
                                    params=case.params)
        tsess = tapi.BoosterSession(cfg, tapi.plan(cfg),
                                    n_global=case.n_global, params=params,
                                    device="cpu")
        snaps = PaddedSnapshot(**{
            f.name: np.asarray(getattr(case.stacked[0], f.name))
            for f in dataclasses.fields(PaddedSnapshot)})
        jsess.run(case.stacked[0])
        tsess.state = state_from_jax(cfg, jax.tree.map(np.asarray,
                                                       jsess.state))
        assert set(tsess.state) == {"h"}
        _close(tsess.run(snaps), jsess.run(case.stacked[0]), "continued")
    finally:
        jops.set_force_ref(False)
    with pytest.raises(ValueError, match="expected keys"):
        state_from_jax(cfg, {"h": np.zeros((4, 4)), "c": np.zeros((4, 4))})
    bad = jax.tree.map(np.asarray, case.params)
    del bad["gru"]["b"]
    with pytest.raises(ValueError, match="expected keys"):
        params_from_jax(cfg, bad)


# ------------------------------------------------------------ wrappers ----

def _wrapper_args(name, device):
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    i = lambda *s: z(*s, dt=torch.int32)
    n, k, din, h = 8, 2, 4, 8
    if name == "ell_spmm":
        return (i(n, k), z(n, k), i(n, k), z(n, din))
    if name == "gcrn_step":
        return (i(n, k), z(n, k), i(n, k), z(n, din), z(n, h), z(n, h),
                z(din, 4 * h), z(h, 4 * h), z(4 * h))
    if name == "stacked_step":
        return (i(n, k), z(n, k), i(n, k), z(n, din), z(n, h), z(din, h),
                z(h), z(h, 3 * h), z(h, 3 * h), z(3 * h))
    return (i(1, 1, n, k), z(1, 1, n, k), i(1, 1, n, k), z(1, 1, n, din),
            i(1, 1, n), z(1, 1, n), z(1, 4, h), z(din, h), z(h),
            z(h, 3 * h), z(h, 3 * h), z(3 * h))


NEW_KERNELS = ("ell_spmm", "gcrn_step", "stacked_step", "stacked_engine")


@pytest.mark.parametrize("name", NEW_KERNELS)
def test_new_wrappers_refuse_other_devices_and_count_no_cpu_run(name):
    wrapper = getattr(engine, name)
    with pytest.raises(ValueError, match="not supported"):
        wrapper(*_wrapper_args(name, "meta"))
    before = dict(engine.LAUNCHES)
    wrapper(*_wrapper_args(name, "cpu"))
    assert engine.LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (python3 chip_smoke.py runs them)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("op", ["ell_spmm", "dgnn_fused_step",
                                "stacked_fused_step"])
def test_step_kernel_matches_plain_on_card(cuda, op, edges):
    d = _inputs(4)
    em = d["em"] if edges else None
    args = {"ell_spmm": (d["idx"], d["coef"], d["eidx"], d["x"], em),
            "dgnn_fused_step": (d["idx"], d["coef"], d["eidx"], d["x"],
                                d["xh"], d["c"], d["wx"], d["wh"], d["b"],
                                em),
            "stacked_fused_step": (d["idx"], d["coef"], d["eidx"], d["x"],
                                   d["h"], d["wg"], d["bg"], d["gx"],
                                   d["gh"], d["gb"], em)}[op]
    targs = [None if a is None else a.to(cuda) for a in _t(*args)]
    fn = getattr(tops, op)
    got, want = fn(*targs), fn(*targs, force_ref=True)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-4)
