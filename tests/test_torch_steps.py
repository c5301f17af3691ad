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
  card they match their plain versions at the kernels' edges, bit for bit
  across two calls (skipped here).
* The launch plans of ``gcrn_step``, ``stacked_step`` and ``ell_spmm``
  (``engine.step_plan``): the grid at the main path's shape, shared memory
  that does not grow with n and takes every width the one-CTA step kernels
  took; on a card, the library's own plan, and stacked_step at the main
  path's shape, past its Wg room and past 65,536 rows (skipped here).
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


# the per-step kernels' edges on the card (chip_smoke.py phase 3a runs the
# same): a partial row tile (n 37), a partial unit slice (H 20), din 12 / 13,
# k 1 / 27 / 33 / 40, a dead tile, a single live row; the SpMM at d 12 / 13 /
# 64 / 128
EDGE_SHAPES = [(37, 5, 12, 24, "mixed"), (37, 1, 13, 20, "mixed"),
               (37, 27, 12, 24, "mixed"), (37, 33, 13, 20, "mixed"),
               (37, 40, 12, 24, "dead"), (37, 40, 13, 20, "one row"),
               (37, 27, 64, 24, "mixed"), (37, 27, 128, 24, "mixed")]


def _edge_inputs(n, k, din, h, live):
    d = _inputs(4, n=n, k=k, din=din, h=h)
    if live == "dead":
        d["coef"][:] = 0.0
    elif live == "one row":
        d["coef"][np.arange(n) != n // 2] = 0.0
        d["coef"][n // 2, -1] = 0.5
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("op", ["ell_spmm", "dgnn_fused_step",
                                "stacked_fused_step"])
def test_step_kernel_matches_plain_on_card(cuda, op, edges, shape):
    d = _edge_inputs(*shape)
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
    got, again = fn(*targs), fn(*targs)
    want = fn(*targs, force_ref=True)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    want = want if isinstance(want, tuple) else (want,)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a), "two calls differ"
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-4)


# ---------------------------------------------------------- launch plans ----

def test_gcrn_step_plan_fills_the_card_at_the_main_shape():
    """BC-Alpha's V2 step (n 640, k 27, din 64, H 128): 20 row tiles x 16
    unit slices, 320 CTAs of 256 threads (more than the H100's 132 SMs),
    the 8 slices of a cluster sharing a tile's aggregation."""
    plan = engine.step_plan("gcrn_step", n=640, k=27, din=64, H=128)
    assert (plan["tiles"], plan["slices"], plan["ctas"]) == (20, 16, 320)
    assert plan["cluster"] == engine.CLUSTER == 8
    assert plan["threads"] == engine.STEP_THREADS == 256
    # the (32, 192 + 4) activation tile and three 64-row weight slots
    assert plan["smem"] == 4 * (32 * 196 + 3 * 64 * 32)


@pytest.mark.parametrize("k", [1, 27, 40])
def test_gcrn_step_smem_does_not_grow_with_n_or_k(k):
    plans = [engine.step_plan("gcrn_step", n=n, k=k, din=64, H=128)
             for n in (1, 37, 640, 100_000)]
    assert len({p["smem"] for p in plans}) == 1
    assert plans[0]["smem"] == engine.smem_bytes("gcrn_step", k=1, din=64,
                                                 H=128)
    assert [p["tiles"] for p in plans] == [1, 2, 20, 3125]


@pytest.mark.parametrize("H, slices", [(8, 8), (20, 8), (64, 8), (72, 16),
                                       (128, 16)])
def test_gcrn_step_pads_its_unit_slices_to_whole_clusters(H, slices):
    plan = engine.step_plan("gcrn_step", n=37, k=5, din=12, H=H)
    assert plan["slices"] == slices and plan["ctas"] == 2 * slices
    assert plan["ctas"] % plan["cluster"] == 0


def _one_cta_smem(k, din, H):
    """The shared memory of the one-CTA gcrn_step kernel the 2-D grid
    replaced: a k-major (din + H, 36) tile and the tile's ELL lanes."""
    return 4 * (din + H) * engine.TILE_STRIDE + engine.TILE_ROWS * k * 12


@pytest.mark.parametrize("k", [1, 5, 27, 40, 64, 300])
def test_gcrn_step_takes_every_width_the_one_cta_kernel_took(k):
    widest = (engine.SMEM_LIMIT - engine.TILE_ROWS * k * 12) // (
        4 * engine.TILE_STRIDE)
    assert _one_cta_smem(k, 1, widest - 1) <= engine.SMEM_LIMIT
    for din in (1, 4, 13, 64, widest // 2, widest - 1):
        assert engine.smem_bytes("gcrn_step", k=k, din=din,
                                 H=widest - din) <= engine.SMEM_LIMIT
    # the new limit: K = din + H up to 1,616, whatever k
    assert engine.smem_bytes("gcrn_step", k=k, din=64,
                             H=1552) <= engine.SMEM_LIMIT
    assert engine.smem_bytes("gcrn_step", k=k, din=64,
                             H=1553) > engine.SMEM_LIMIT


@pytest.mark.parametrize("d, aligned, row_threads, vec", [
    (64, True, 16, 4), (128, True, 32, 4), (13, True, 16, 1),
    (64, False, 32, 1), (256, True, 32, 4), (12, True, 16, 4)])
def test_ell_spmm_plan(d, aligned, row_threads, vec):
    """A row takes a warp, or half of one where it is at most 16 vectors
    wide (d 64 in float4s, d 13 in floats); 256-thread CTAs over the rows,
    the graphs in the grid's y."""
    plan = engine.step_plan("ell_spmm", L=3, n=640, d=d, aligned=aligned)
    assert (plan["row_threads"], plan["vec"]) == (row_threads, vec)
    assert plan["threads"] == engine.SPMM_THREADS == 256
    assert plan["rows"] == 256 // row_threads
    assert plan["grid"] == (-(-640 // plan["rows"]), 3)
    assert plan["ctas"] == plan["grid"][0] * 3


def test_stacked_step_plan_fills_the_card_at_the_main_shape():
    """BC-Alpha's stacked V2 step (n 640, k 27, din = dmid = H = 128): 20
    row tiles x 16 unit slices, 320 CTAs of 256 threads, the 8 slices of a
    cluster sharing the tile's aggregation and its node transform."""
    plan = engine.step_plan("stacked_step", n=640, k=27, din=128, dmid=128,
                            H=128)
    assert (plan["tiles"], plan["slices"], plan["ctas"]) == (20, 16, 320)
    assert plan["cluster"] == engine.CLUSTER == 8
    assert plan["threads"] == engine.STEP_THREADS == 256
    # the agg tile (32 x 132), the [nt | h] tile (32 x 260), three 64-row
    # slots of 3 gates x 8 units, and the Wg slice (128 x 16)
    assert plan["wg_smem"]
    assert plan["smem"] == 4 * (32 * 132 + 32 * 260 + 3 * 64 * 24 + 128 * 16)


@pytest.mark.parametrize("k", [1, 27, 40])
def test_stacked_step_smem_does_not_grow_with_n_or_k(k):
    plans = [engine.step_plan("stacked_step", n=n, k=k, din=128, dmid=128,
                              H=128) for n in (1, 37, 640, 100_000)]
    assert len({p["smem"] for p in plans}) == 1
    assert plans[0]["smem"] == engine.smem_bytes(
        "stacked_step", k=1, din=128, dmid=128, H=128)
    assert [p["tiles"] for p in plans] == [1, 2, 20, 3125]
    assert all(p["ctas"] == p["tiles"] * 16 for p in plans)


@pytest.mark.parametrize("H, slices", [(8, 8), (20, 8), (64, 8), (72, 16),
                                       (128, 16)])
def test_stacked_step_pads_its_unit_slices_to_whole_clusters(H, slices):
    plan = engine.step_plan("stacked_step", n=37, k=5, din=12, dmid=19, H=H)
    assert plan["slices"] == slices and plan["ctas"] == 2 * slices
    assert plan["ctas"] % plan["cluster"] == 0


def _one_cta_stacked_smem(k, din, dmid, H):
    """The shared memory of the one-CTA stacked_step kernel the cluster
    design replaced: k-major (din + dmid + H, 36) tiles and the tile's ELL
    lanes (three words a lane)."""
    return 4 * (din + dmid + H) * engine.TILE_STRIDE \
        + engine.TILE_ROWS * k * 12


@pytest.mark.parametrize("k", [1, 5, 27, 40, 300])
def test_stacked_step_takes_every_width_the_one_cta_kernel_took(k):
    """Every (din, dmid, H) the one-CTA kernel took at this k still fits:
    the widest sums din + dmid + H, split every way over the three."""
    widest = (engine.SMEM_LIMIT - engine.TILE_ROWS * k * 12) // (
        4 * engine.TILE_STRIDE)
    assert _one_cta_stacked_smem(k, 1, 1, widest - 2) <= engine.SMEM_LIMIT
    assert _one_cta_stacked_smem(k, 1, 1, widest - 1) > engine.SMEM_LIMIT
    for din in (1, 4, 13, 64, 128, widest // 3, widest // 2, widest - 2):
        for dmid in (1, 8, 19, 128, (widest - din) // 2, widest - din - 1):
            H = widest - din - dmid
            if min(dmid, H) < 1:
                continue
            assert engine.smem_bytes("stacked_step", k=k, din=din,
                                     dmid=dmid, H=H) <= engine.SMEM_LIMIT, \
                (din, dmid, H)


def test_stacked_step_reads_wg_from_l2_past_its_room():
    """Where the Wg column slice does not fit beside the tiles, it is read
    from global memory (L2): same launch, the sums unchanged."""
    assert engine.stacked_step_wg_in_smem(128, 128, 128)
    assert not engine.stacked_step_wg_in_smem(600, 600, 400)
    assert engine.step_plan("stacked_step", n=37, k=1, din=600, dmid=600,
                            H=400)["wg_smem"] is False
    assert engine.smem_bytes("stacked_step", k=1, din=600, dmid=600,
                             H=400) <= engine.SMEM_LIMIT


def test_step_plan_names_only_the_per_step_kernels():
    with pytest.raises(ValueError, match="has no step plan"):
        engine.step_plan("fused_gru", Bs=1, H=8)


@pytest.mark.cuda
@pytest.mark.parametrize("name, dims", [
    ("gcrn_step", dict(n=640, k=27, din=64, H=128)),
    *[("gcrn_step", dict(n=n, k=k, din=din, H=h))
      for n, k, din, h, _ in EDGE_SHAPES],
    ("gcrn_step", dict(n=37, k=5, din=64, H=1552)),
    ("stacked_step", dict(n=640, k=27, din=128, dmid=128, H=128)),
    *[("stacked_step", dict(n=n, k=k, din=din, dmid=din + 7, H=h))
      for n, k, din, h, _ in EDGE_SHAPES],
    ("stacked_step", dict(n=37, k=1, din=600, dmid=600, H=400)),
    ("stacked_step", dict(n=37, k=1, din=16, dmid=8, H=1587)),
    *[("ell_spmm", dict(L=L, n=n, d=d, aligned=a))
      for L, n, d, a in ((1, 640, 64, 1), (1, 640, 128, 1), (3, 37, 13, 1),
                         (2, 37, 64, 0), (1, 37, 12, 1), (1, 5, 256, 1))]])
def test_step_plan_matches_library_on_card(cuda, name, dims):
    assert engine.library_step_plan(name, **dims) == engine.step_plan(
        name, **dims)


# stacked_step on the card at the main path's widths (n 640, k 27, din =
# dmid = H = 128), past its Wg room (Wg read from L2), at the widest H at k
# 1, and past 65,536 rows; a third of the rows live, the rest padding (no
# lanes, h 0: the padding tiles' shortcut)
STACKED_CARD_SHAPES = [(640, 27, 128, 128, 128), (640, 27, 64, 128, 128),
                       (37, 1, 600, 600, 400), (37, 1, 16, 8, 1587),
                       (66_000, 27, 128, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STACKED_CARD_SHAPES)
@pytest.mark.parametrize("edges", [False, True])
def test_stacked_step_wide_matches_plain_on_card(cuda, shape, edges):
    n, k, din, dmid, h = shape
    d = _inputs(11, n=n, k=k, din=din, dmid=dmid, h=h)
    d["coef"][n // 3:] = 0.0
    d["h"][n // 3:] = 0.0
    args = [None if a is None else a.to(cuda) for a in _t(
        d["idx"], d["coef"], d["eidx"], d["x"], d["h"], d["wg"], d["bg"],
        d["gx"], d["gh"], d["gb"], d["em"] if edges else None)]
    got, again = (tops.stacked_fused_step(*args) for _ in range(2))
    want = tops.stacked_fused_step(*args, force_ref=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two calls differ"
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4)
