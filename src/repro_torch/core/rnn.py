"""Recurrent cells (GRU / LSTM) and EvolveGCN-O's matrix-GRU.

``fused=False`` computes each gate's matmul separately (the paper's
unpipelined RNN baseline); ``fused=True`` issues all gates as one
concatenated matmul. The two are the same function.

The matrix-GRU reuses the GRU cell: the columns of the weight matrix are
the batch, and the matrix is both input and hidden state.

Initialisers draw from an explicit ``torch.Generator`` on the CPU; callers
move the parameters to their device.
"""
from __future__ import annotations

import math

import torch


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    scale = math.sqrt(2.0 / (shape[0] + shape[-1]))
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def init_gru(gen: torch.Generator, din: int, hidden: int) -> dict:
    return {
        "wx": _glorot(gen, (din, 3 * hidden)),    # [r | z | n]
        "wh": _glorot(gen, (hidden, 3 * hidden)),
        "b": torch.zeros(3 * hidden, dtype=torch.float32),
    }


def gru_cell(params: dict, x: torch.Tensor, h: torch.Tensor, *,
             fused: bool = True) -> torch.Tensor:
    if fused:
        gx = x @ params["wx"] + params["b"]
        gh = h @ params["wh"]
        rx, zx, nx = gx.chunk(3, dim=-1)
        rh, zh, nh = gh.chunk(3, dim=-1)
    else:
        wxr, wxz, wxn = params["wx"].chunk(3, dim=-1)
        whr, whz, whn = params["wh"].chunk(3, dim=-1)
        br, bz, bn = params["b"].chunk(3, dim=-1)
        rx, zx, nx = x @ wxr + br, x @ wxz + bz, x @ wxn + bn
        rh, zh, nh = h @ whr, h @ whz, h @ whn
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1.0 - z) * n + z * h


def init_lstm(gen: torch.Generator, din: int, hidden: int) -> dict:
    b = torch.zeros(4 * hidden, dtype=torch.float32)
    b[hidden:2 * hidden] = 1.0  # forget-gate bias 1.0 (standard)
    return {
        "wx": _glorot(gen, (din, 4 * hidden)),    # [i | f | g | o]
        "wh": _glorot(gen, (hidden, 4 * hidden)),
        "b": b,
    }


def lstm_gates(params: dict, x: torch.Tensor, h: torch.Tensor, *,
               fused: bool = True) -> torch.Tensor:
    if fused:
        return x @ params["wx"] + h @ params["wh"] + params["b"]
    wx4 = params["wx"].chunk(4, dim=-1)
    wh4 = params["wh"].chunk(4, dim=-1)
    b4 = params["b"].chunk(4, dim=-1)
    return torch.cat([x @ a + h @ c + d for a, c, d in zip(wx4, wh4, b4)],
                     dim=-1)


def lstm_apply_gates(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, *, fused: bool = True):
    """One LSTM step: (h', c')."""
    return lstm_apply_gates(lstm_gates(params, x, h, fused=fused), c)


def matrix_gru(params: dict, w: torch.Tensor, *,
               fused: bool = True) -> torch.Tensor:
    """EvolveGCN-O weight evolution: W^t = GRU(input=W^{t-1},
    hidden=W^{t-1}). ``w`` is (..., din, dout); its columns are the GRU
    batch, so the cell runs on w^T with feature dim din."""
    wt = w.transpose(-1, -2)
    return gru_cell(params, wt, wt, fused=fused).transpose(-1, -2)
