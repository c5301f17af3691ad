"""The port's fused GRU / LSTM cells compute the JAX package's function.

``repro_torch.kernels.ops.fused_gru`` / ``fused_lstm`` on the CPU (the
kernel wrappers' plain versions) against the JAX package's Pallas kernels
``fused_gru_pallas`` / ``fused_lstm_pallas`` in interpret mode, at
tests/test_kernels.py's shapes, on the same numpy inputs made from a seed:
within 2e-4, that test's tolerance. Both refuse a batch that is not a
multiple of the row tile ``tb``.

PyTorch's ``torch.gru_cell`` / ``torch.lstm_cell`` with the weights
transposed and a zero hidden bias compute the same function (gate orders
r | z | n and i | f | g | o, no bias on the hidden products): pinned here
within 1e-6, so chip_smoke.py's library column times the same work. The
port never calls them.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
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
