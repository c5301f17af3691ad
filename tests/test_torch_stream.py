"""The port's stream engine computes the JAX package's function.

For the three dense-snapshot families (gcrn, stacked, evolve; tgn and
static_gcn in tests/test_torch_temporal.py),
``repro_torch.kernels.ops``
``stream_steps[_batched]`` on the CPU — the kernel path (pack, the kernel
wrapper's plain version, unpack) and the force-ref path — must match the
JAX package's stream oracle on the same numpy inputs
(``harness.stream_kernel_case``): solo, batched, ragged with a length-0
row, D-blocked ``td``, and the evolve no-op freeze. Tolerance 3e-4, the
harness's own.

The JAX side runs through ``ops.stream_steps[_batched](force_ref=True)``:
with the installed jax the Pallas interpret path of ``stream_call`` does
not build (``pltpu.TPUCompilerParams`` is gone; tests/test_registry.py
fails the same way), so its oracle is the reference here.

The kernel-versus-plain tests need a CUDA card and skip without one.
"""
import numpy as np
import pytest
import torch

import harness
from repro.kernels import ops as jops
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops

ATOL = 3e-4
FAMILIES = ("gcrn", "stacked", "evolve")


def _flat(res):
    out = []
    for r in res:
        out.extend(r if isinstance(r, (tuple, list)) else (r,))
    return [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in out]


def _assert_close(got, want, label):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), label
    assert np.isfinite(want[0]).all() and np.abs(want[0]).max() > 0, label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"{label}[{i}]")


def _jax(family, args, batched, lengths=None):
    if batched:
        return jops.stream_steps_batched(family, *args, tn=32,
                                         lengths=lengths, force_ref=True)
    return jops.stream_steps(family, *args, tn=32, force_ref=True)


def _port(family, args, batched, lengths=None, **kw):
    if batched:
        return tops.stream_steps_batched(family, *args, tn=32,
                                         lengths=lengths, device="cpu", **kw)
    return tops.stream_steps(family, *args, tn=32, device="cpu", **kw)


@pytest.mark.parametrize("force_ref", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_stream_steps_match_jax(family, batched, force_ref):
    args, _, d = harness.stream_kernel_case(family, seed=3,
                                            B=3 if batched else None)
    want = _jax(family, args, batched)
    got = _port(family, args, batched, force_ref=force_ref)
    _assert_close(got, want, f"{family} batched={batched} ref={force_ref}")


@pytest.mark.parametrize("family", FAMILIES)
def test_ragged_lengths_with_empty_row_match_jax(family):
    args, _, _ = harness.stream_kernel_case(family, seed=4, B=3)
    lengths = np.array([3, 0, 2], np.int32)
    want = _jax(family, args, True, lengths)
    for force_ref in (False, True):
        got = _port(family, args, True, lengths, force_ref=force_ref)
        _assert_close(got, want, f"{family} ragged ref={force_ref}")
    # the length-0 row leaves its state exactly as it came in
    got = _flat(_port(family, args, True, lengths))
    state0 = args[5][0] if family == "evolve" else args[6]
    np.testing.assert_array_equal(got[1][1], np.asarray(state0)[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_td_blocking_is_the_same_function(family):
    args, _, d = harness.stream_kernel_case(family, seed=5)
    assert d // (d // 2) >= 2
    base = _port(family, args, False, td=None)
    for td in (d // 2, 8):
        _assert_close(_port(family, args, False, td=td), base,
                      f"{family} td={td}")
    _assert_close(base, _jax(family, args, False), family)


@pytest.mark.parametrize("force_ref", [False, True])
def test_evolve_noop_steps_freeze_weights(force_ref):
    (stream, ws, bg, gwx, gwh, gb, _) = harness.random_evolve_inputs(
        7, 4, 32, 4, [(12, 16), (16, 8)], noop=(0, 1, 2, 3))
    idx, coef, x, mask, live = stream
    assert not live.any()
    args = (idx, coef, x, mask, live, [np.asarray(w) for w in ws],
            *[[np.asarray(a) for a in p] for p in (bg, gwx, gwh, gb)])
    outs, wT = _port("evolve", args, False, force_ref=force_ref)
    for w, w0 in zip(wT, ws):
        np.testing.assert_array_equal(w.numpy(), np.asarray(w0))
    assert not outs.any()


@pytest.mark.parametrize("fused", [True, False])
def test_cells_and_step_ops_match_jax(fused):
    """Port core/rnn.py and kernels/ref.py per-step ops vs the JAX ones."""
    from repro.core import rnn as jrnn
    from repro.kernels import ref as jref
    from repro_torch.core import rnn as trnn
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    n, k, din, h, e = 20, 5, 6, 8, 30
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    eidx = rng.integers(0, e, (n, k)).astype(np.int32)
    coef = f32(n, k)
    x, hs, cs, em = f32(n, din), f32(n, h), f32(n, h), f32(e, din)
    lstm = {"wx": f32(din, 4 * h), "wh": f32(h, 4 * h), "b": f32(4 * h)}
    gru = {"wx": f32(h, 3 * h), "wh": f32(h, 3 * h), "b": f32(3 * h)}
    t = lambda tree: {k_: torch.from_numpy(v) for k_, v in tree.items()}
    T = torch.from_numpy
    w = f32(h, 5)
    pairs = [
        (trnn.gru_cell(t(gru), T(hs), T(hs), fused=fused),
         jrnn.gru_cell(gru, hs, hs, fused=fused)),
        (trnn.lstm_apply_gates(trnn.lstm_gates(t(lstm), T(x), T(hs),
                                               fused=fused), T(cs)),
         jrnn.lstm_apply_gates(jrnn.lstm_gates(lstm, x, hs, fused=fused),
                               cs)),
        (trnn.matrix_gru(t(gru), T(w), fused=fused),
         jrnn.matrix_gru(gru, w, fused=fused)),
        (tref.ell_spmm(T(idx), T(coef), T(eidx), T(x), T(em)),
         jref.ell_spmm(idx, coef, eidx, x, em)),
        (tref.dgnn_fused_step(T(idx), T(coef), T(eidx), T(x), T(hs), T(cs),
                              *t(lstm).values(), T(em)),
         jref.dgnn_fused_step(idx, coef, eidx, x, hs, cs, *lstm.values(),
                              em)),
    ]
    for i, (got, want) in enumerate(pairs):
        for g, wv in zip(_flat([got]), _flat([want])):
            np.testing.assert_allclose(g, wv, atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_event_and_static_families_run_on_the_cpu(family):
    """tgn and static_gcn, once NotImplementedError in the port, run on the
    CPU and match the JAX oracle; tgn's hbm_paged still names its ROADMAP
    item (static_gcn has nothing to page: tests/test_torch_temporal.py)."""
    args, _, _ = harness.stream_kernel_case(family, seed=3, B=2)
    want = _jax(family, args, True)
    _assert_close(_port(family, args, True), want, family)
    if family == "tgn":
        with pytest.raises(NotImplementedError, match="item 11"):
            _port(family, args, True, state_residency="hbm_paged", td=8)


def test_unknown_family_and_paged_residency_raise():
    with pytest.raises(KeyError, match="unknown stream-engine family"):
        tops.stream_steps("gat", device="cpu")
    args, _, _ = harness.stream_kernel_case("gcrn", seed=1)
    with pytest.raises(NotImplementedError, match="item 11"):
        tops.stream_steps("gcrn", *args, state_residency="hbm_paged", td=8,
                          device="cpu")


def test_row_table_int64_renumber_and_sentinel():
    ren = torch.tensor([[5, -1, 2**31 - 2, 0]], dtype=torch.int64)
    rowg = tops._row_index_table(ren, 2**31 - 1)
    assert rowg.dtype == torch.int32
    assert rowg.tolist() == [[5, 2**31 - 1, 2**31 - 2, 0]]
    with pytest.raises(ValueError, match="int32"):
        tops._row_index_table(ren, 2**31)
    with pytest.raises(ValueError, match="past the store"):
        tops._row_index_table(ren, 7)


@pytest.mark.parametrize("batched", [False, True])
def test_renumber_past_the_store_raises(batched):
    """A row id >= n_global would be the kernel's drop sentinel: the state
    row would be lost without a word, so the launch path refuses it."""
    args, _, _ = harness.stream_kernel_case("gcrn", seed=6,
                                            B=3 if batched else None)
    args = list(args)
    ren = np.array(args[4])
    n_global = np.asarray(args[6]).shape[-2]
    ren[..., 0, 0] = n_global
    args[4] = ren
    with pytest.raises(ValueError, match="past the store"):
        _port("gcrn", args, batched)


@pytest.mark.parametrize("family", FAMILIES)
def test_pack_is_what_the_launch_hands_the_wrapper(family):
    """``ops.pack`` + the wrapper's plain version reproduce the batched
    launch, ragged lengths included (chip_smoke.py checks the kernels on
    these packed inputs)."""
    args, _, _ = harness.stream_kernel_case(family, seed=7, B=3)
    lengths = [3, 0, 2]
    want = _port(family, args, True, lengths)
    targs = tops.to_device(tuple(args), "cpu")
    packed = tops.pack(family, *targs, lengths=lengths)
    if family != "evolve":
        got = getattr(engine, f"{family}_plain")(*packed)
    else:
        outs, wT = engine.evolve_plain(*packed)
        dims = [w.shape[-2:] for w in targs[5]]
        got = (outs[..., :dims[-1][1]],
               [wT[:, i, :di, :do] for i, (di, do) in enumerate(dims)])
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------- kernels on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream-engine kernels have no "
                    "CPU mode (python3 chip_smoke.py runs them)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_matches_plain_on_card(cuda, family):
    args, _, _ = harness.stream_kernel_case(family, seed=3, B=3)
    lengths = np.array([3, 1, 2], np.int32)
    name = f"{family}_engine"
    before = engine.LAUNCHES[name]
    got = tops.stream_steps_batched(family, *args, tn=32, lengths=lengths,
                                    device=cuda)
    torch.cuda.synchronize()
    assert engine.LAUNCHES[name] == before + 1
    want = tops.stream_steps_batched(family, *args, tn=32, lengths=lengths,
                                     device=cuda, force_ref=True)
    assert engine.LAUNCHES[name] == before + 1
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g, w, atol=1e-4)
