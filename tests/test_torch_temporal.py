"""The event-driven TGN and the static GCN in the port match the JAX package.

Inputs come from numpy seeds and go to both packages; parameters cross over
through ``params_from_jax`` / ``state_from_jax``. Covered, on the CPU (the
kernel wrappers' plain versions):

* ``pad_event_block`` / ``unpad_event_block``: equal arrays, equal errors;
* ``TGNModel.step`` against the JAX step at small width (in 5, hidden 8,
  G 40) and the v3 stream, solo and batched ragged ``[4, 2, 1]``, against
  the JAX oracle;
* the kernel-level cases ``harness.stream_kernel_case("tgn" |
  "static_gcn")`` through ``ops.stream_steps[_batched]``;
* ``StaticGCN.step`` with ``impl`` "xla" and "pallas" (the JAX ELL SpMM in
  interpret mode), the v3 fold, ragged dead slots, the T > 1 and hbm_paged
  errors;
* sessions (``run``, ``run_batched``) and ``run_arrays`` for both configs,
  and the executors' handling of an event-block stream and an empty state.

The JAX stream engine does not build with the installed jax
(``pltpu.TPUCompilerParams``, see tests/test_torch_stream.py), so its v3
side runs through its oracle (``force_ref`` / ``ops.set_force_ref``).
Tolerances: 3e-4 for streams (the harness's own), 1e-5 for single steps.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import harness
from repro import api as japi
from repro.configs.dgnn import STATIC_GCN as J_STATIC
from repro.configs.dgnn import TGN as J_TGN
from repro.core import dataflow as jdataflow
from repro.core.tgn import TGNModel as JTGNModel
from repro.graph import events as jevents
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import dataflow as tdataflow
from repro_torch.graph import events as tevents
from repro_torch.graph.padding import PaddedSnapshot, stack_ragged
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops
from repro_torch.params import params_from_jax, state_from_jax

ATOL = 3e-4
ATOL_STEP = 1e-5
G_GLOBAL = 40
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_oracle():
    jops.set_force_ref(True)
    yield
    jops.set_force_ref(False)


def _port_cfg(cfg) -> DGNNConfig:
    return DGNNConfig(**dataclasses.asdict(cfg))


def _port_block(b) -> tevents.PaddedEventBlock:
    return tevents.PaddedEventBlock(**{
        f.name: np.asarray(getattr(b, f.name))
        for f in dataclasses.fields(tevents.PaddedEventBlock)})


def _port_snaps(s) -> PaddedSnapshot:
    return PaddedSnapshot(**{f.name: np.asarray(getattr(s, f.name))
                             for f in dataclasses.fields(PaddedSnapshot)})


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _close(got, want, label, atol=ATOL):
    want = _np(want)
    assert np.isfinite(want).all(), label
    np.testing.assert_allclose(_np(got), want, atol=atol, err_msg=label)


def _flat(res):
    out = []
    for r in res:
        out.extend(r if isinstance(r, (tuple, list)) else (r,))
    return out


# ----------------------------------------------------- event padding ----

def _events(seed, n_events=None):
    rng = np.random.default_rng(seed)
    e = int(rng.integers(2, 9)) if n_events is None else n_events
    src = rng.integers(0, G_GLOBAL, e)
    dst = (src + rng.integers(1, G_GLOBAL, e)) % G_GLOBAL
    ts = rng.uniform(0.0, 10.0, e).astype(np.float32)
    return src, dst, ts


def _feat_table(in_dim=5):
    return np.random.default_rng(0).normal(
        size=(G_GLOBAL, in_dim)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pad_and_unpad_event_block_match_jax(seed):
    src, dst, ts = _events(seed)
    ft = _feat_table()
    want = jevents.pad_event_block(src, dst, ts, ft, n_pad=16, k_max=8)
    got = tevents.pad_event_block(src, dst, ts, ft, n_pad=16, k_max=8)
    for f in dataclasses.fields(tevents.PaddedEventBlock):
        a, b = np.asarray(getattr(got, f.name)), np.asarray(
            getattr(want, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (got.n_pad, got.k_max) == (16, 8)
    for a, b in zip(tevents.unpad_event_block(got),
                    jevents.unpad_event_block(want)):
        np.testing.assert_array_equal(a, b)
    dev = got.to("cpu")
    assert torch.is_tensor(dev.neigh_ts) and dev.neigh_idx.dtype == torch.int32


@pytest.mark.parametrize("case", ["self_loop", "n_pad", "k_max", "shape"])
def test_pad_event_block_errors_match_jax(case):
    src, dst, ts = _events(3, n_events=6)
    n_pad, k_max = 16, 8
    if case == "self_loop":
        dst = src.copy()
    elif case == "n_pad":
        n_pad = 3
    elif case == "k_max":
        src, dst = np.zeros(5, np.int64), np.arange(1, 6)
        ts, k_max = np.ones(5, np.float32), 4
    else:
        ts = ts[:-1]
    ft = _feat_table()
    with pytest.raises(ValueError) as want:
        jevents.pad_event_block(src, dst, ts, ft, n_pad=n_pad, k_max=k_max)
    with pytest.raises(ValueError) as got:
        tevents.pad_event_block(src, dst, ts, ft, n_pad=n_pad, k_max=k_max)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- TGN ----

def _random_stream(seed, T, ft, n_pad=16, k_max=8):
    """T random event batches, the JAX blocks and their (T, ...) stack."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(T):
        src, dst, ts = _events(int(rng.integers(1 << 30)))
        blocks.append(jevents.pad_event_block(src, dst, ts, ft, n_pad=n_pad,
                                              k_max=k_max))
    return blocks, jax.tree.map(lambda *xs: np.stack(xs), *blocks)


@pytest.fixture(scope="module")
def tgn_case():
    jcfg = dataclasses.replace(J_TGN, in_dim=5, hidden=8, out_dim=8)
    jmodel = JTGNModel(jcfg, n_global=G_GLOBAL)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = _port_cfg(jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    model = tdataflow.build_model(cfg, n_global=G_GLOBAL)
    return jcfg, jmodel, jparams, cfg, model, params, _feat_table()


def _jax_tgn_args(jmodel, jparams, state, blocks):
    g = jparams["gru"]
    return (blocks.neigh_idx, blocks.neigh_coef, blocks.neigh_ts,
            blocks.node_feat, blocks.renumber, blocks.node_mask,
            state["mem"], jparams["freq"], jparams["w_in"], g["wx"],
            g["wh"], g["b"])


@pytest.mark.parametrize("mode", ["baseline", "v3"])
def test_tgn_step_matches_jax(tgn_case, mode):
    jcfg, jmodel, jparams, cfg, model, params, ft = tgn_case
    blocks, _ = _random_stream(5, 4, ft)
    mem0 = np.random.default_rng(9).normal(
        size=(G_GLOBAL, jcfg.hidden)).astype(np.float32) * 0.5
    jstate = {"mem": jax.numpy.asarray(mem0)}
    tstate = state_from_jax(cfg, {"mem": mem0})
    for t, blk in enumerate(blocks):
        jstate, want = jmodel.step(jparams, jstate, blk, mode=mode)
        tstate, got = model.step(params, tstate, _port_block(blk).to("cpu"),
                                 mode=mode)
        _close(got, want, f"step {t} out", ATOL_STEP)
        _close(tstate["mem"], jstate["mem"], f"step {t} mem", ATOL_STEP)


@pytest.mark.parametrize("force_ref", [False, True])
def test_tgn_stream_solo_and_ragged_batched_match_jax_oracle(tgn_case,
                                                             force_ref):
    jcfg, jmodel, jparams, cfg, model, params, ft = tgn_case
    state0 = jmodel.init_state(jparams)
    _, blocks_T = _random_stream(7, 5, ft)
    want = jops.stream_steps("tgn", *_jax_tgn_args(jmodel, jparams, state0,
                                                   blocks_T), force_ref=True)
    tstate, got = model.step_stream(
        params, model.init_state(params), _port_block(blocks_T).to("cpu"),
        force_ref=force_ref)
    _close(got, want[0], "solo outs")
    _close(tstate["mem"], want[1], "solo mem")

    B, T, lengths = 3, 4, [4, 2, 1]
    streams = [_random_stream(97 * b + 1, T, ft)[1] for b in range(B)]
    blocks_BT = jax.tree.map(lambda *xs: np.stack(xs), *streams)
    states0 = jax.tree.map(lambda a: np.broadcast_to(a[None], (B,) + a.shape),
                           state0)
    want = jops.stream_steps_batched(
        "tgn", *_jax_tgn_args(jmodel, jparams, states0, blocks_BT),
        lengths=np.asarray(lengths, np.int32), force_ref=True)
    tstates = tdataflow.init_states_batched(model, params, B)
    tst, got = model.step_stream_batched(
        params, tstates, _port_block(blocks_BT).to("cpu"), lengths=lengths,
        force_ref=force_ref)
    _close(got, want[0], "batched outs")
    _close(tst["mem"], want[1], "batched mem")
    # dead tail batches leave the store as a shorter stream would
    _, solo = model.step_stream(
        params, model.init_state(params),
        _port_block(jax.tree.map(lambda a: a[2, :1], blocks_BT)).to("cpu"))
    _close(got[2, :1], solo, "ragged row 2")


def test_tgn_launch_validates_timestamps(tgn_case):
    jcfg, jmodel, jparams, cfg, model, params, ft = tgn_case
    _, blocks_T = _random_stream(3, 2, ft)
    blk = _port_block(blocks_T)
    bad = dataclasses.replace(blk, neigh_ts=np.asarray(blk.neigh_ts,
                                                       np.int32))
    with pytest.raises(ValueError, match="must be floating, got int32"):
        model.step_stream(params, model.init_state(params), bad.to("cpu"))
    bad = dataclasses.replace(blk, neigh_ts=np.asarray(blk.neigh_ts)[..., :3])
    with pytest.raises(ValueError, match="must match the ELL lane shape"):
        model.step_stream(params, model.init_state(params), bad.to("cpu"))


# ----------------------------------------------- kernel-level cases ----

def _jax_case(family, args, batched, lengths=None):
    if batched:
        return jops.stream_steps_batched(family, *args, tn=32,
                                         lengths=lengths, force_ref=True)
    return jops.stream_steps(family, *args, tn=32, force_ref=True)


def _port_case(family, args, batched, lengths=None, **kw):
    if batched:
        return tops.stream_steps_batched(family, *args, tn=32,
                                         lengths=lengths, device="cpu", **kw)
    return tops.stream_steps(family, *args, tn=32, device="cpu", **kw)


@pytest.mark.parametrize("force_ref", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_stream_kernel_case_matches_jax(family, batched, force_ref):
    args, _, _ = harness.stream_kernel_case(family, seed=3,
                                            B=3 if batched else None)
    want = _jax_case(family, args, batched)
    got = _port_case(family, args, batched, force_ref=force_ref)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) and np.abs(_np(want[0])).max() > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{family} batched={batched} ref={force_ref} [{i}]")


@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_ragged_kernel_case_with_empty_row_matches_jax(family):
    args, _, _ = harness.stream_kernel_case(family, seed=4, B=3)
    # static_gcn runs T = 1: lengths are per-slot liveness
    lengths = np.array([3, 0, 2] if family == "tgn" else [1, 0, 1], np.int32)
    want = _flat(_jax_case(family, args, True, lengths))
    for force_ref in (False, True):
        got = _flat(_port_case(family, args, True, lengths,
                               force_ref=force_ref))
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{family} ragged ref={force_ref} [{i}]")
    assert not _np(got[0])[1].any()  # the length-0 row outputs zeros
    if family == "tgn":  # and leaves its memory as it came in
        np.testing.assert_array_equal(_np(got[1])[1], np.asarray(args[6])[1])


@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_pack_is_what_the_launch_hands_the_wrapper(family):
    """``ops.pack`` + the wrapper's plain version reproduce the batched
    launch (chip_smoke.py holds the kernels to the plain versions on these
    packed inputs)."""
    args, _, _ = harness.stream_kernel_case(family, seed=7, B=3)
    lengths = [3, 0, 2] if family == "tgn" else [1, 0, 1]
    want = _flat(_port_case(family, args, True, lengths))
    packed = tops.pack(family, *tops.to_device(tuple(args), "cpu"),
                       lengths=lengths)
    if family == "tgn":
        got = engine.tgn_plain(*packed)
    else:
        got = [engine.static_plain(*packed)[..., :args[4][-1].shape[-1]]]
    for g, w in zip(_flat(got), want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_tgn_pack_refuses_local_ids_outside_the_batch():
    args, _, _ = harness.stream_kernel_case("tgn", seed=2, B=2)
    args = list(args)
    idx = np.array(args[0])
    idx[0, 0, 0, 0] = idx.shape[-2]
    args[0] = idx
    with pytest.raises(ValueError, match="outside"):
        _port_case("tgn", args, True)


# ---------------------------------------------------------- static ----

@pytest.fixture(scope="module")
def static_case():
    case = harness.make_case("static-gcn", T=4, B=3)
    cfg = _port_cfg(case.cfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, case.params))
    return case, cfg, params


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_static_step_matches_jax(static_case, impl):
    case, cfg, params = static_case
    jmodel = jdataflow.build_model(case.cfg, impl=impl,
                                   n_global=case.n_global)
    tmodel = tdataflow.build_model(cfg, impl=impl, n_global=case.n_global)
    snaps = case.stacked[0]
    for t in range(2):
        snap = jax.tree.map(lambda a: np.asarray(a)[t], snaps)
        jstate, want = jmodel.step(case.params, {}, snap)
        tstate, got = tmodel.step(params, {}, _port_snaps(snap).to("cpu"))
        assert jstate == {} and tstate == {}
        _close(got, want, f"{impl} step {t}", ATOL_STEP)


@pytest.mark.parametrize("force_ref", [False, True])
def test_static_v3_fold_and_ragged_dead_slots_match_jax(jax_oracle,
                                                        static_case,
                                                        force_ref):
    case, cfg, params = static_case
    jmodel = case.model
    tmodel = tdataflow.build_model(cfg, n_global=case.n_global)
    _, want = jmodel.step_stream(case.params, {}, case.stacked[0], tn=32)
    _, got = tmodel.step_stream(params, {},
                                _port_snaps(case.stacked[0]).to("cpu"),
                                force_ref=force_ref)
    _close(got, want, "fold")
    lengths = [4, 1, 0]
    sBT = jax.tree.map(lambda *xs: np.stack(xs), *case.stacked)
    _, want = jmodel.step_stream_batched(case.params, {}, sBT, tn=32,
                                         lengths=np.asarray(lengths))
    state, got = tmodel.step_stream_batched(
        params, {}, _port_snaps(sBT).to("cpu"), lengths=lengths,
        force_ref=force_ref)
    assert state == {}
    _close(got, want, "batched ragged")
    for b, t_b in enumerate(lengths):
        assert not got[b, t_b:].any(), f"row {b}: a dead slot is not zero"


def test_static_kernel_path_refuses_multi_step_streams(static_case):
    case, cfg, params = static_case
    s = _port_snaps(case.stacked[0]).to("cpu")
    args = (s.neigh_idx, s.neigh_coef, s.node_feat, s.node_mask,
            [p["w"] for p in params["gcn"]], [p["b"] for p in params["gcn"]])
    with pytest.raises(ValueError, match="fold independent snapshots"):
        tops.stream_steps("static_gcn", *args, device="cpu")
    # the oracle takes any T: its steps are independent
    (outs,) = tops.stream_steps("static_gcn", *args, device="cpu",
                                force_ref=True)
    assert outs.shape[0] == 4


def test_static_hbm_paged_has_nothing_to_page(static_case):
    case, cfg, params = static_case
    model = tdataflow.build_model(cfg, n_global=case.n_global)
    snaps = _port_snaps(case.stacked[0]).to("cpu")
    with pytest.raises(ValueError, match="no recurrent store to page"):
        model.step_stream(params, {}, snaps, state_residency="hbm_paged")
    with pytest.raises(ValueError, match="no recurrent store to page"):
        model.step_stream_batched(params, {}, stack_ragged([snaps], "cpu")[0],
                                  buffer_depth=2)
    args, _, _ = harness.stream_kernel_case("static_gcn", seed=1)
    with pytest.raises(ValueError, match="no state to page"):
        tops.stream_steps("static_gcn", *args, state_residency="hbm_paged",
                          td=8, device="cpu")


# -------------------------------------------------------- sessions ----

def _tgn_session_pair(tgn_case, level):
    jcfg, jmodel, jparams, cfg, model, params, ft = tgn_case
    jsess = japi.BoosterSession(jcfg, japi.plan(jcfg, level=level),
                                n_global=G_GLOBAL, params=jparams)
    tsess = tapi.BoosterSession(cfg, tapi.plan(cfg, level=level),
                                n_global=G_GLOBAL, params=params,
                                device="cpu")
    return jsess, tsess


@pytest.mark.parametrize("level", ["baseline", "v3"])
def test_tgn_session_matches_jax(jax_oracle, tgn_case, level):
    jsess, tsess = _tgn_session_pair(tgn_case, level)
    ft = tgn_case[-1]
    for seed in (11, 12):  # two chunks: the memory carries over
        _, blocks_T = _random_stream(seed, 4, ft)
        want = jsess.run(blocks_T)
        _close(tsess.run(_port_block(blocks_T)), want, f"{level} run")
    _close(tsess.state["mem"], jsess.state["mem"], f"{level} mem")
    T = [4, 4, 4] if level == "baseline" else [4, 2, 3]
    streams = [jax.tree.map(lambda a, t=t: a[:t], _random_stream(s, 4, ft)[1])
               for s, t in zip((21, 22, 23), T)]
    jstates, jouts = jsess.run_batched(streams)
    tstates, touts = tsess.run_batched([_port_block(s) for s in streams])
    for b, (g, w) in enumerate(zip(touts, jouts)):
        assert g.shape[0] == T[b]
        _close(g, w, f"{level} row {b}")
    _close(tstates["mem"], jstates["mem"], f"{level} batched mem")


@pytest.mark.parametrize("level", ["baseline", "v3"])
def test_static_session_matches_jax(jax_oracle, static_case, level):
    case, cfg, params = static_case
    jsess = japi.BoosterSession(case.cfg, japi.plan(case.cfg, level=level),
                                n_global=case.n_global, params=case.params)
    tsess = tapi.BoosterSession(cfg, tapi.plan(cfg, level=level),
                                n_global=case.n_global, params=params,
                                device="cpu")
    assert tsess.state == {}
    _close(tsess.run(_port_snaps(case.stacked[1])),
           jsess.run(case.stacked[1]), f"{level} run")
    T = [4, 4, 4] if level == "baseline" else [4, 2, 3]
    streams = [jax.tree.map(lambda a, t=t: np.asarray(a)[:t], s)
               for s, t in zip(case.stacked, T)]
    jstates, jouts = jsess.run_batched(streams)
    tstates, touts = tsess.run_batched([_port_snaps(s) for s in streams])
    assert tstates == {}
    for b, (g, w) in enumerate(zip(touts, jouts)):
        _close(g, w, f"{level} row {b}")


@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_run_arrays_matches_jax(family):
    args, _, _ = harness.stream_kernel_case(family, seed=8, B=2)
    want = _flat(japi.run_arrays(japi.plan(family=family, batch=2, tn=32),
                                 *args, force_ref=True))
    got = _flat(tapi.run_arrays(tapi.plan(family=family, batch=2, tn=32),
                                *args, device="cpu"))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{family} [{i}]")


# ---------------------------------------------- executors and repairs ----

@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_run_plan_batched_reads_the_batch_from_any_leaf(tgn_case,
                                                        static_case, family):
    """The batch size comes from the first state leaf ({"mem"}) or, for an
    empty state, from the snapshots."""
    if family == "tgn":
        cfg, model, params = tgn_case[3], tgn_case[4], tgn_case[5]
        streams = [_port_block(_random_stream(s, 2, tgn_case[-1])[1])
                   for s in (1, 2, 3)]
    else:
        case, cfg, params = static_case
        model = tdataflow.build_model(cfg, n_global=case.n_global)
        streams = [_port_snaps(s) for s in case.stacked]
    snaps_BT, _ = stack_ragged(streams, "cpu")
    states = tdataflow.init_states_batched(model, params, 3)
    for level in ("baseline", "v3"):
        state, outs = tdataflow.run_plan_batched(
            model, params, states, snaps_BT,
            tapi.plan(cfg, level=level, batch=3))
        assert outs.shape[0] == 3 and set(state) == set(states)
        with pytest.raises(ValueError, match="plan.batch=2 but the state "
                                             "batch is 3"):
            tdataflow.run_plan_batched(model, params, states, snaps_BT,
                                       tapi.plan(cfg, level=level, batch=2))


def test_stack_ragged_and_at_keep_the_event_block_type(tgn_case):
    ft = tgn_case[-1]
    streams = [_port_block(_random_stream(s, t, ft)[1])
               for s, t in ((1, 3), (2, 1))]
    stacked, lens = stack_ragged(streams, "cpu")
    assert isinstance(stacked, tevents.PaddedEventBlock) and lens == [3, 1]
    assert tuple(stacked.neigh_ts.shape) == (2, 3, 16, 8)
    # the short stream's tail repeats its last batch
    np.testing.assert_array_equal(stacked.neigh_ts[1, 2].numpy(),
                                  streams[1].neigh_ts[0])
    one = tdataflow._at(tdataflow._at(stacked, 0), 2)
    assert isinstance(one, tevents.PaddedEventBlock)
    np.testing.assert_array_equal(one.renumber.numpy(),
                                  streams[0].renumber[2])


def test_state_from_jax_knows_mem_and_the_empty_state(tgn_case):
    cfg = tgn_case[3]
    mem = np.ones((2, G_GLOBAL, 8), np.float32)
    state = state_from_jax(cfg, {"mem": mem})
    assert set(state) == {"mem"} and state["mem"].shape == (2, G_GLOBAL, 8)
    assert state_from_jax(_port_cfg(J_STATIC), {}) == {}
    with pytest.raises(ValueError, match="expected keys"):
        state_from_jax(cfg, {"h": mem})
    with pytest.raises(ValueError, match="expected keys"):
        state_from_jax(_port_cfg(J_STATIC), {"mem": mem})


def test_chip_smoke_checks_tgn_outputs_at_memory_width():
    """chip_smoke's output-width rule: TGN outputs are its memory
    (cfg.hidden), the static GCN's its last layer (cfg.out_dim)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    T = 2
    for cfg in (smoke.TGN, smoke.STATIC_GCN):
        wins = smoke.windows_for(cfg, "v3")
        width = cfg.hidden if cfg.dgnn_type == "event_memory" else cfg.out_dim
        outs = torch.ones(T, smoke.N_PAD, width)
        outs_b = [torch.ones(b - a, smoke.N_PAD, width) for a, b in wins]
        state = ({"mem": torch.zeros(3, 4)} if cfg is smoke.TGN else {})
        res = (outs, state, outs_b, state)
        smoke.check_path(cfg.name, cfg, "v3", res, res, T)
