"""The port's fused GRU / LSTM cells compute the JAX package's function.

``repro_torch.kernels.ops.fused_gru`` / ``fused_lstm`` on the CPU (the
kernel wrappers' plain versions) against the JAX package's Pallas kernels
``fused_gru_pallas`` / ``fused_lstm_pallas`` in interpret mode, at
tests/test_kernels.py's shapes, on the same numpy inputs made from a seed:
within 2e-4, that test's tolerance. Both refuse a batch that is not a
multiple of the row tile ``tb``. The same at the CUDA kernel's edges (a
partial 32-row tile, a partial 8-unit slice, a K that is no multiple of 4),
and its shared memory does not grow with din or H.

``core/rnn.lstm_cell`` against the JAX one, fused and not, within 1e-6.

PyTorch's ``torch.gru_cell`` / ``torch.lstm_cell`` with the weights
transposed and a zero hidden bias compute the same function (gate orders
r | z | n and i | f | g | o, no bias on the hidden products): pinned here
within 1e-6, so chip_smoke.py's library column times the same work. The
port never calls them.
"""
import numpy as np
import pytest
import torch

from repro.core import rnn as jrnn
from repro.kernels import ops as jops
from repro_torch.core import rnn as trnn
from repro_torch.kernels import engine, ref
from repro_torch.kernels import ops as tops


def _inputs(seed, b, din, h, gates, with_c=False):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    x, hh = f32(b, din), f32(b, h)
    c = (f32(b, h),) if with_c else ()
    return (x, hh, *c, f32(din, gates * h), f32(h, gates * h), f32(gates * h))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,din,h", [(128, 32, 64), (256, 64, 128),
                                     (384, 128, 96)])
def test_fused_gru_matches_the_pallas_kernel(b, din, h):
    args = _inputs(0, b, din, h, 3)
    engine.reset_launches()
    got = tops.fused_gru(*args, tb=128, device="cpu")
    assert not any(engine.LAUNCHES.values())
    want = np.asarray(jops.fused_gru(*args, tb=128))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(
        tops.fused_gru(*args, force_ref=True, device="cpu").numpy(), want,
        atol=2e-4, rtol=0)


@pytest.mark.parametrize("b,din,h", [(128, 32, 64), (256, 48, 128)])
def test_fused_lstm_matches_the_pallas_kernel(b, din, h):
    args = _inputs(1, b, din, h, 4, with_c=True)
    got = tops.fused_lstm(*args, tb=128, device="cpu")
    want = jops.fused_lstm(*args, tb=128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0)


# (Bs, din, H, tb): the CUDA kernel's 32-row tile and 8-unit slice end
# part-way (40 rows, H 20 and 18), din 13 stages 4-byte copies, din 16
# 16-byte ones
@pytest.mark.parametrize("b,din,h,tb", [(40, 13, 24, 8), (40, 16, 20, 8),
                                        (96, 13, 18, 48)])
@pytest.mark.parametrize("cell", ["fused_gru", "fused_lstm"])
def test_edge_shapes_match_the_pallas_kernel(cell, b, din, h, tb):
    gates = 3 if cell == "fused_gru" else 4
    args = _inputs(5, b, din, h, gates, with_c=cell == "fused_lstm")
    got = getattr(tops, cell)(*args, tb=tb, device="cpu")
    want = getattr(jops, cell)(*args, tb=tb)
    if cell == "fused_gru":
        got, want = (got,), (want,)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0)


@pytest.mark.parametrize("cell", ["fused_gru", "fused_lstm"])
def test_cell_shared_memory_does_not_grow_with_the_widths(cell):
    """The cells stage fixed chunks through a fixed ring: the same bytes
    at any din and H, within a CTA's share of the card (the library's own
    figure at both widths: the card test below and chip_smoke.py)."""
    narrow = engine.smem_bytes(cell, din=13, H=24)
    assert narrow == engine.smem_bytes(cell, din=1024, H=1024)
    assert 0 < narrow <= engine.SMEM_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fused_gru", "fused_lstm"])
def test_cell_library_shared_memory_and_grid_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell kernel's library is built "
                    "with nvcc (python3 chip_smoke.py runs it)")
    for din, h in ((13, 24), (1024, 1024)):
        assert engine.library_smem_bytes(cell, din=din, H=h) == \
            engine.smem_bytes(cell, din=din, H=h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert engine.library_ctas(cell, 640, 128) >= sms


@pytest.mark.parametrize("fused", [True, False])
def test_lstm_cell_matches_jax(fused):
    rng = np.random.default_rng(6)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    din, h = 12, 20
    params = {"wx": f32(din, 4 * h), "wh": f32(h, 4 * h), "b": f32(4 * h)}
    x, hs, cs = f32(7, din), f32(7, h), f32(7, h)
    got = trnn.lstm_cell({k: torch.from_numpy(v) for k, v in params.items()},
                         *_t((x, hs, cs)), fused=fused)
    want = jrnn.lstm_cell(params, x, hs, cs, fused=fused)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("cell", ["fused_gru", "fused_lstm"])
def test_batch_must_be_a_multiple_of_tb(cell):
    args = _inputs(2, 192, 16, 32, 3 if cell == "fused_gru" else 4,
                   with_c=cell == "fused_lstm")
    with pytest.raises(AssertionError):  # the JAX kernel asserts it
        getattr(jops, cell)(*args, tb=128)
    with pytest.raises(ValueError, match="batch 192 is not a multiple of "
                       "the row tile tb=128"):
        getattr(tops, cell)(*args, tb=128, device="cpu")
    getattr(tops, cell)(*args, tb=64, device="cpu")  # 192 = 3 x 64


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_torch_cell_computes_the_same_function(cell):
    """torch.gru_cell / torch.lstm_cell (the library column of
    chip_smoke.py) against the plain versions of the kernels."""
    if cell == "gru":
        x, h, wx, wh, b = _t(_inputs(3, 64, 24, 40, 3))
        got = torch.gru_cell(x, h, wx.T, wh.T, b, torch.zeros_like(b))
        want = ref.fused_gru(x, h, wx, wh, b)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)
    else:
        x, h, c, wx, wh, b = _t(_inputs(4, 64, 24, 40, 4, with_c=True))
        got = torch.lstm_cell(x, (h, c), wx.T, wh.T, b, torch.zeros_like(b))
        want = ref.fused_lstm(x, h, c, wx, wh, b)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                       rtol=0)
