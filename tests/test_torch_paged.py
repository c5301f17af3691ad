"""HBM-paged state residency in the port (state_residency="hbm_paged").

The contracts of tests/test_paged.py, held on the CPU at narrow widths
(``harness.stream_kernel_case``, td = 8), where each paged kernel wrapper
(``engine.<family>_engine_paged``) runs its plain version:

  1. EXACTNESS: for every stateful family, solo and batched-ragged
     (lengths (4, 2, 0)), at ring depths 1, 2 and 4, a paged call matches
     the resident port within 1e-6 and the JAX package's oracle within
     3e-4, the harness's tolerance (``ops.stream_steps[_batched](
     force_ref=True)``: the JAX paged engine does not build under the
     installed jax, whose stream_call reaches a removed
     ``pltpu.TPUCompilerParams``).
  2. The plan API: ``plan(state_residency=, buffer_depth=)`` through
     ``run_arrays``, solo and batched-ragged (test_paged.py's plan test).
  3. Rejections: the JAX stream_call's messages, pinned equal.
  4. ACCOUNTING: ``engine.smem_bytes``, the shared-memory estimate that
     chip_smoke.py holds equal to each library's own on the card: the
     resident EvolveGCN at D = 256 is over the card's 227 KB and the paged
     one (td 16, depth 2) is under; every paged engine fits at the main
     path's widths at depth 4; no estimate grows with the store height G;
     the paged EvolveGCN's is linear in D at a fixed td (no D x D buffer).
  5. CAPACITY: the resident EvolveGCN at D = 256 refuses with the JAX
     package's hint to page, and the paged one runs and matches.

On the card the paged kernels are held bit-for-bit (``torch.equal``)
against the resident ones by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import harness
from repro import api as japi
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops

STATEFUL = ("gcrn", "stacked", "evolve", "tgn")
ATOL = 3e-4


def _flat(res):
    out = []
    for r in res:
        out.extend(r if isinstance(r, (tuple, list)) else (r,))
    return [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in out]


def _assert_close(got, want, atol, label):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), label
    assert np.abs(want[0]).max() > 0, label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{label}[{i}]")


def _paged(depth):
    return dict(td=8, state_residency="hbm_paged", buffer_depth=depth)


# ------------------------------------------------------- exactness ----

@pytest.mark.parametrize("family", STATEFUL)
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_paged_solo_matches_resident_and_jax(family, depth):
    args, _, _ = harness.stream_kernel_case(family, seed=3, T=3)
    engine.reset_launches()
    got = tops.stream_steps(family, *args, tn=32, device="cpu",
                            **_paged(depth))
    resident = tops.stream_steps(family, *args, tn=32, device="cpu")
    assert not any(engine.LAUNCHES.values())  # CPU: plain versions only
    _assert_close(got, resident, 1e-6, f"{family} d{depth} vs resident")
    want = jops.stream_steps(family, *args, tn=32, force_ref=True)
    _assert_close(got, want, ATOL, f"{family} d{depth} vs jax")


@pytest.mark.parametrize("family", STATEFUL)
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_paged_batched_ragged_matches_resident_and_jax(family, depth):
    args, _, _ = harness.stream_kernel_case(family, seed=11, T=4, B=3)
    for lengths in (None, (4, 2, 0)):
        got = tops.stream_steps_batched(family, *args, tn=32,
                                        lengths=lengths, device="cpu",
                                        **_paged(depth))
        resident = tops.stream_steps_batched(family, *args, tn=32,
                                             lengths=lengths, device="cpu")
        label = f"{family} d{depth} lengths={lengths}"
        _assert_close(got, resident, 1e-6, f"{label} vs resident")
        want = jops.stream_steps_batched(family, *args, tn=32,
                                         lengths=lengths, force_ref=True)
        _assert_close(got, want, ATOL, f"{label} vs jax")


def test_paged_through_plan_api():
    """plan(state_residency=, buffer_depth=) reaches the paged wrapper
    through run_arrays, solo and batched-ragged (test_paged.py:122)."""
    args, _, _ = harness.stream_kernel_case("gcrn", seed=5, T=3)
    base = tapi.run_arrays(tapi.plan(family="gcrn", tn=32, td=8), *args,
                           device="cpu")
    paged = tapi.run_arrays(
        tapi.plan(family="gcrn", tn=32, td=8, state_residency="hbm_paged",
                  buffer_depth=4), *args, device="cpu")
    _assert_close(paged, base, 1e-6, "gcrn plan")
    _assert_close(paged, japi.run_arrays(japi.plan(family="gcrn", tn=32,
                                                   td=8), *args,
                                         force_ref=True), ATOL, "gcrn jax")

    argsB, _, _ = harness.stream_kernel_case("tgn", seed=6, T=4, B=3)
    pb = dict(family="tgn", tn=32, td=8, batch=3, lengths=(4, 2, 1))
    baseB = tapi.run_arrays(tapi.plan(**pb), *argsB, device="cpu")
    pagedB = tapi.run_arrays(
        tapi.plan(**pb, state_residency="hbm_paged", buffer_depth=2),
        *argsB, device="cpu")
    _assert_close(pagedB, baseB, 1e-6, "tgn plan")
    _assert_close(pagedB, japi.run_arrays(japi.plan(**pb), *argsB,
                                          force_ref=True), ATOL, "tgn jax")


def test_paged_depth_defaults_to_two():
    """buffer_depth=None is depth 2 under hbm_paged, as in the JAX ops."""
    args, _, _ = harness.stream_kernel_case("stacked", seed=8, T=3)
    got = tops.stream_steps("stacked", *args, td=8, device="cpu",
                            state_residency="hbm_paged")
    want = tops.stream_steps("stacked", *args, device="cpu", **_paged(2))
    _assert_close(got, want, 0.0, "depth None")


# ------------------------------------------------------ rejections ----

@pytest.mark.parametrize("kwargs", [
    dict(state_residency="hbm_paged"),                       # no td
    dict(state_residency="hbm_paged", td=8, buffer_depth=3),
    dict(state_residency="hbm", td=8),
])
def test_paged_rejections_match_jax(kwargs):
    args, _, _ = harness.stream_kernel_case("gcrn", seed=1, T=2)
    with pytest.raises(ValueError) as want:
        jops.stream_steps("gcrn", *args, tn=32, **kwargs)
    with pytest.raises(ValueError) as got:
        tops.stream_steps("gcrn", *args, tn=32, device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,n_args", [
    ("gcrn_engine_paged", 11), ("evolve_engine_paged", 10),
    ("stacked_engine_paged", 12), ("tgn_engine_paged", 12)])
def test_paged_wrappers_check_the_ring(name, n_args):
    """A window must be a positive multiple of 8 columns (16-byte row
    copies; the evolve micro-tile's 8 columns), the ring 1, 2 or 4 deep."""
    wrapper = getattr(engine, name)
    with pytest.raises(ValueError, match="td=12 must be a positive multiple"):
        wrapper(*([None] * n_args), td=12, depth=2)
    with pytest.raises(ValueError, match="depth=3 must be one of"):
        wrapper(*([None] * n_args), td=8, depth=3)


# ------------------------------------------------------ accounting ----

# the main path's widths (configs/dgnn.py, BC-Alpha: n_pad 640, k_max 27;
# TGN's event batches k_max 22)
MAIN = {"gcrn_engine_paged": dict(k=27, din=64, H=128, n=640),
        "stacked_engine_paged": dict(k=27, din=64, dmid=128, H=128),
        "evolve_engine_paged": dict(k=27, D=128),
        "tgn_engine_paged": dict(k=22, din=64, H=128, n=640)}


def test_resident_evolve_at_d256_is_over_the_card_and_paged_is_under():
    resident = engine.smem_bytes("evolve_engine", k=27, D=256)
    paged = engine.smem_bytes("evolve_engine_paged", k=27, D=256, td=16,
                              depth=2)
    assert resident == 305920 > engine.SMEM_LIMIT
    assert paged <= engine.SMEM_LIMIT
    # the resident limit sits between D = 216 and D = 224
    assert engine.smem_bytes("evolve_engine", k=27, D=216) \
        <= engine.SMEM_LIMIT < engine.smem_bytes("evolve_engine", k=27, D=224)


@pytest.mark.parametrize("name", sorted(MAIN))
def test_every_paged_engine_fits_depth_4_at_the_main_path_widths(name):
    for depth in engine.RING_DEPTHS:
        assert engine.smem_bytes(name, td=16, depth=depth,
                                 **MAIN[name]) <= engine.SMEM_LIMIT
    # a ring of depth d holds d slots
    one, two = (engine.smem_bytes(name, td=16, depth=d, **MAIN[name])
                for d in (1, 2))
    four = engine.smem_bytes(name, td=16, depth=4, **MAIN[name])
    assert four - two == 2 * (two - one) > 0


def test_no_estimate_grows_with_the_store_height():
    """The stores stay in global memory: no engine's shared memory is a
    function of G (the JAX contract 4, "no full store"), and the paged
    evolve engine has no D x D buffer: its estimate is linear in D."""
    for name, (dims, _) in engine._SMEM.items():
        assert "G" not in dims, name
    est = [engine.smem_bytes("evolve_engine_paged", k=27, D=d, td=16,
                             depth=2) for d in (64, 128, 192, 256)]
    steps = np.diff(est)
    assert (steps == steps[0]).all() and steps[0] > 0
    resident = [engine.smem_bytes("evolve_engine", k=27, D=d)
                for d in (64, 128, 192, 256)]
    assert len(set(np.diff(resident))) > 1  # the D x D copy: quadratic


# -------------------------------------------------------- capacity ----

def _wide_evolve_case(T=3, n=16, k=4):
    """EvolveGCN stream-kernel inputs whose square width is 256."""
    stream, ws, bg, gwx, gwh, gb, _ = harness.random_evolve_inputs(
        4, T, n, k, [(12, 256), (256, 8)])
    return (*stream, ws, bg, gwx, gwh, gb)


def test_oversized_store_runs_only_paged():
    """A store over the card's shared memory refuses to launch resident,
    with the JAX package's hint to page, and runs paged."""
    args = _wide_evolve_case()
    with pytest.raises(ValueError, match="over the 232448-byte budget — "
                       r"page the state store with plan\(state_residency="
                       r"'hbm_paged', td=\.\.\.\)"):
        tops.stream_steps("evolve", *args, device="cpu")
    got = tops.stream_steps("evolve", *args, device="cpu", td=16,
                            state_residency="hbm_paged", buffer_depth=2)
    want = jops.stream_steps("evolve", *args, force_ref=True)
    _assert_close(got, want, ATOL, "evolve D=256 paged")


def test_paged_over_budget_says_shrink_td():
    """A paged launch over the budget raises (no switch to another
    kernel), with the JAX hint for a paged store."""
    args, _, _ = harness.stream_kernel_case("gcrn", seed=2, T=2)
    with pytest.raises(ValueError, match="hbm_paged, td=256.*shrink td"):
        tops.stream_steps("gcrn", *args, device="cpu", td=256,
                          state_residency="hbm_paged", buffer_depth=4)
