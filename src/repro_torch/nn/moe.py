"""Mixture-of-Experts MLP (the counterpart of ``repro.nn.moe``).

softmax -> top-k -> renormalized combine, on the JAX package's ``dense``
path: every expert is computed on every token and the top-k gates pick
their outputs, exact and O(E) in work. The JAX package's ``ep`` path (a
``shard_map`` that buckets token copies by expert shard and exchanges them
with ``all_to_all``) needs a device mesh, which the port does not build
yet: ``impl="ep"`` raises ``NotImplementedError`` (ROADMAP.md queue 1,
device sharding), and ``"auto"`` is the dense path.

Parameters keep the JAX layout, padded experts included
(``cfg.padded_experts(tp)``): the router masks the padding with -1e9
before the softmax, so a padded expert is never picked.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn.layers import ACT_DTYPE, normal_init, silu
from repro_torch.nn.mlp import init_mlp, mlp_block

#: the ROADMAP item that ports the expert-parallel path, by its title
EP_ITEM = "ROADMAP.md queue 1, device sharding"


def init_moe(generator, cfg: ModelConfig, tp: int, *, device="cuda",
             dtype=torch.float32) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    e_pad = cfg.padded_experts(tp)
    down_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    init = lambda shape, scale: normal_init(generator, shape, scale,
                                            device=device, dtype=dtype)
    p = {
        "router": init((d, e_pad), 0.02),
        "w_gate": init((e_pad, d, f), 0.02),
        "w_up": init((e_pad, d, f), 0.02),
        "w_down": init((e_pad, f, d), down_scale),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, cfg.n_shared_experts * f,
                               cfg.n_layers, device=device, dtype=dtype)
    return p


def _route(router_w: torch.Tensor, x2: torch.Tensor, cfg: ModelConfig):
    """x2 (t, d) -> (gates (t, k) fp32 renormalized, eidx (t, k) int64).

    The logits are fp32; under ``set_lowmem_norm`` they come from the bf16
    token stream and router with fp32 accumulation (a bf16 product is
    exact in fp32), without an fp32 copy of the stream's type."""
    if L.LOWMEM_NORM:
        logits = x2.to(ACT_DTYPE).float() @ router_w.to(ACT_DTYPE).float()
    else:
        logits = x2.float() @ router_w.float()
    emask = torch.where(torch.arange(logits.shape[-1], device=x2.device)
                        < cfg.n_experts, 0.0, -1e9)
    probs = torch.softmax(logits + emask, dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eidx


def _moe_dense(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every expert on every token (the three einsums in the activation
    dtype), combined with the top-k gates in fp32."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gates, eidx = _route(p["router"], x2, cfg)
    e_pad = p["w_gate"].shape[0]
    # combine weights (t, E): the top-k gates scattered into their experts
    comb = (F.one_hot(eidx, e_pad).float() * gates[..., None]).sum(dim=1)
    g = torch.einsum("td,edf->tef", x2, p["w_gate"].to(ACT_DTYPE))
    u = torch.einsum("td,edf->tef", x2, p["w_up"].to(ACT_DTYPE))
    h = silu(g) * u
    y = torch.einsum("tef,efd->ted", h, p["w_down"].to(ACT_DTYPE))
    out = torch.einsum("ted,te->td", y.float(), comb)
    return out.to(x.dtype).reshape(b, s, d)


def moe_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    """MoE sublayer (no norm / residual). x: (B, S, D).

    ``"auto"`` is the dense path: the JAX package takes its expert-parallel
    one only over a mesh's model axis wider than 1, and the port has no
    mesh. Its ``fsdp``, ``cf_send`` and ``cf_local`` steer that path alone."""
    if impl not in ("auto", "dense", "ep"):
        raise ValueError(f"moe impl {impl!r}: one of 'auto', 'dense', 'ep'")
    if impl == "ep":
        raise NotImplementedError(
            f"the expert-parallel MoE (impl='ep') is not ported yet "
            f"({EP_ITEM})")
    y = _moe_dense(p, cfg, x)
    if cfg.n_shared_experts:
        y = y + mlp_block(p["shared"], x, act=silu)
    return y
