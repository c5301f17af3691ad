"""SwiGLU MLP (the counterpart of ``repro.nn.mlp``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import ACT_DTYPE, normal_init


def init_mlp(generator, d: int, f: int, n_layers: int, *, device="cuda",
             dtype=torch.float32):
    down_scale = 0.02 / math.sqrt(2 * n_layers)
    init = lambda shape, scale: normal_init(generator, shape, scale,
                                            device=device, dtype=dtype)
    return {
        "w_gate": init((d, f), 0.02),
        "w_up": init((d, f), 0.02),
        "w_down": init((f, d), down_scale),
    }


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): silu(x W_gate) * (x W_up), then W_down; bf16."""
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(ACT_DTYPE))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(ACT_DTYPE))
    h = F.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(ACT_DTYPE))
