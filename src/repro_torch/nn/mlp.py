"""SwiGLU MLP (the counterpart of ``repro.nn.mlp``). Under a mesh the
intermediate is sharded on "ffn" (the 'model' axis): column-parallel gate
and up, row-parallel down."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import Axes, gather_fsdp, shard
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


def mlp_axes() -> dict:
    return {
        "w_gate": Axes("embed_fsdp", "ffn"),
        "w_up": Axes("embed_fsdp", "ffn"),
        "w_down": Axes("ffn", "embed_fsdp"),
    }


def mlp_block(p: dict, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): act(x W_gate) * (x W_up), then W_down; bf16.
    ``act`` is the fused ``F.silu``, or ``layers.silu`` where the SwiGLU
    rounds as the JAX package's does op by op (the MoE / Mamba2 models)."""
    g = torch.einsum("bsd,df->bsf", x, gather_fsdp(
        p["w_gate"].to(ACT_DTYPE), "embed_fsdp", "ffn"))
    u = torch.einsum("bsd,df->bsf", x, gather_fsdp(
        p["w_up"].to(ACT_DTYPE), "embed_fsdp", "ffn"))
    h = act(g) * u
    h = shard(h, "batch", None, "ffn")
    return torch.einsum("bsf,fd->bsd", h, gather_fsdp(
        p["w_down"].to(ACT_DTYPE), "ffn", "embed_fsdp"))
