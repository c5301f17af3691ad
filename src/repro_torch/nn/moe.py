"""Mixture-of-Experts MLP (the counterpart of ``repro.nn.moe``).

Two execution paths, same math (softmax -> top-k -> renormalized combine):

dense    every expert computed on every token, combined with the top-k
         gates: exact, O(E) work.

ep       expert parallelism over the current mesh's 'model' axis
         (``distributed.sharding_ctx``; the JAX package's ``shard_map``),
         run by every rank on its block of the tokens:
           1. route tokens locally (router weights replicated),
           2. bucket token copies by destination model-shard (stable sort
              + within-bucket position, capacity-dropped, GShard-style),
           3. ``all_to_all`` over the 'model' group to the expert owners,
           4. re-bucket by local expert and run the SwiGLU as one batched
              product over experts,
           5. ``all_to_all`` back, gate, and scatter-add (``index_add_``)
              into the tokens.
         With ``fsdp`` the expert weights' embed dim is sharded over
         'data' and all-gathered in bf16 before use (explicit ZeRO-3).

Capacity factors make every buffer static-shape; a dropped token copy
loses its expert's contribution. ``"auto"`` takes ``ep`` only over a
model axis wider than 1, as the JAX package does; ``"ep"`` without a mesh
raises :class:`MeshRequiredError`.

Under a mesh the dense path runs on DTensors like the rest of the LM:
its experts sharded over 'model' ("experts"), each rank computes its
experts' share and the combine sums over them.

Parameters keep the JAX layout, padded experts included
(``cfg.padded_experts(tp)``): the router masks the padding with -1e9
before the softmax, so a padded expert is never picked.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import (Axes, current_mesh, gather_fsdp,
                                         local_block,
                                         mesh_axis_sizes, placements,
                                         replicated, shard)
from repro_torch.nn import layers as L
from repro_torch.nn.layers import ACT_DTYPE, normal_init, silu
from repro_torch.nn.mlp import init_mlp, mlp_axes, mlp_block



class MeshRequiredError(RuntimeError):
    """The expert-parallel path was asked for with no current mesh."""


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


def moe_axes(cfg: ModelConfig) -> dict:
    ax = {
        "router": Axes(None, None),
        "w_gate": Axes("experts", "embed_fsdp", None),
        "w_up": Axes("experts", "embed_fsdp", None),
        "w_down": Axes("experts", None, "embed_fsdp"),
    }
    if cfg.n_shared_experts:
        ax["shared"] = mlp_axes()
    return ax


def _route(router_w: torch.Tensor, x2: torch.Tensor, cfg: ModelConfig):
    """x2 (t, d) -> (gates (t, k) fp32 renormalized, eidx (t, k) int64).

    The logits are fp32; under ``set_lowmem_norm`` they come from the bf16
    token stream and router with fp32 accumulation (a bf16 product is
    exact in fp32), without an fp32 copy of the stream's type."""
    if L.LOWMEM_NORM:
        logits = x2.to(ACT_DTYPE).float() @ router_w.to(ACT_DTYPE).float()
    else:
        logits = x2.float() @ router_w.float()
    emask = replicated(torch.where(
        torch.arange(logits.shape[-1], device=x2.device) < cfg.n_experts,
        0.0, -1e9), logits)
    probs = torch.softmax(logits + emask, dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eidx


def _merge_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B * S, D). Under a mesh the sequence is gathered
    first and the merge is made on each rank's block (batch split over
    ('pod', 'data')), so the gradient comes back in those placements."""
    b, s, d = x.shape
    if not isinstance(x, DTensor):
        return x.reshape(b * s, d)
    x = shard(x, "batch", None, None)
    local = x.to_local()
    return DTensor.from_local(local.reshape(-1, d), x.device_mesh,
                              x.placements, run_check=False,
                              shape=torch.Size((b * s, d)),
                              stride=(d, 1))


def _moe_dense(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every expert on every token (the three einsums in the activation
    dtype), combined with the top-k gates in fp32. On DTensors, each rank
    runs its experts on its tokens (``_experts_on_blocks``)."""
    b, s, d = x.shape
    x2 = _merge_tokens(x)
    ws = (gather_fsdp(p["w_gate"].to(ACT_DTYPE), "experts", "embed_fsdp",
                      None),
          gather_fsdp(p["w_up"].to(ACT_DTYPE), "experts", "embed_fsdp", None),
          gather_fsdp(p["w_down"].to(ACT_DTYPE), "experts", None,
                      "embed_fsdp"))
    if isinstance(x2, DTensor):
        return _experts_on_blocks(p["router"], cfg, x2, ws, x.dtype,
                                  (b, s, d))
    return _dense_experts(p["router"], cfg, 0, x2, *ws).to(
        x.dtype).reshape(b, s, d)


def _dense_experts(router_w, cfg: ModelConfig, lo: int, x2, w_gate, w_up,
                   w_down):
    """The routing of tokens x2 (t, d) over all experts, then the experts
    ``lo`` to ``lo + len(w_gate)``, combined with their gates in fp32."""
    gates, eidx = _route(router_w, x2, cfg)
    # combine weights (t, E): the top-k gates scattered into their experts
    comb = (F.one_hot(eidx, router_w.shape[1]).float()
            * gates[..., None]).sum(dim=1)
    comb = comb[:, lo:lo + w_gate.shape[0]]
    g = torch.einsum("td,edf->tef", x2, w_gate)
    u = torch.einsum("td,edf->tef", x2, w_up)
    h = silu(g) * u
    y = torch.einsum("tef,efd->ted", h, w_down)
    return torch.einsum("ted,te->td", y.float(), comb)


def _experts_on_blocks(router, cfg, x2, ws, dtype, shape):
    """The dense experts under a mesh, each rank on its block: its tokens
    (x2's placements), routed over all experts with the whole router, and
    its experts (the weights' "experts" split). The partial sums over the
    experts' split are reduced in fp32, then cast. A gradient is summed
    over each mesh axis on which its tensor is whole but the work is
    split (the tokens' axes for the weights and the router, the experts'
    axis for the tokens and the router)."""
    mesh = x2.device_mesh
    router = replicated(router, x2)
    split = [isinstance(q, Shard) for q in x2.placements]
    experts = [isinstance(q, Shard) for q in ws[0].placements]
    lo = 0
    for i, e in enumerate(experts):
        if e:
            lo = mesh.get_coordinate()[i] * ws[0].to_local().shape[0]
    summed = lambda pl, over: [Partial() if isinstance(q, Replicate) and o
                               else q for q, o in zip(pl, over)]
    x_pl, r_pl = list(x2.placements), list(router.placements)
    w_pl = [list(w.placements) for w in ws]
    either = [a or b for a, b in zip(split, experts)]
    out_pl = [Shard(0) if sp else Partial() if e else Replicate()
              for sp, e in zip(split, experts)]
    out = local_map(
        lambda r, x, *w: _dense_experts(r, cfg, lo, x, *w),
        out_placements=out_pl, in_placements=(r_pl, x_pl, *w_pl),
        in_grad_placements=(summed(r_pl, either), summed(x_pl, experts),
                            *(summed(pl, split) for pl in w_pl)),
        device_mesh=mesh)(router, x2, *ws)
    out = out.redistribute(mesh, [Shard(0) if sp else Replicate()
                                  for sp in split]).to(dtype)
    b, s, d = shape
    return DTensor.from_local(out.to_local().reshape(-1, s, d), mesh,
                              out.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=(s * d, d, 1))


# ------------------------------------------------------------------- ep ----


def _bucket_by(dest: torch.Tensor, n_buckets: int, capacity: int):
    """Sort ids by bucket; return (order, slot, valid) where slot is the
    flat position dest * capacity + within-bucket position, or the trash
    slot n_buckets * capacity where the copy is dropped."""
    order = torch.argsort(dest, stable=True)
    d_sorted = dest[order]
    first = torch.searchsorted(
        d_sorted, torch.arange(n_buckets, device=dest.device), side="left")
    pos = torch.arange(dest.shape[0], device=dest.device) - first[d_sorted]
    valid = pos < capacity
    slot = torch.where(valid, d_sorted * capacity + pos,
                       n_buckets * capacity)
    return order, slot, valid


def _all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim`` (tiled);
    differentiable (the backward reduce-scatters the gradient)."""
    return torch.cat(dist_nn.all_gather(t.contiguous(), group=group), dim=dim)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The equal-split exchange; its transpose, the backward, is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal chunks of ``t``'s leading axis to each rank of ``group``, the
    received chunks in rank order (the JAX ``all_to_all`` over axis 0);
    differentiable."""
    return _AllToAll.apply(t, group)


def _ep_body(x, router_w, w_gate, w_up, w_down, *, cfg: ModelConfig,
             tp: int, e_pad: int, cap_send: int, cap_local: int, fsdp: bool,
             mesh, stats):
    """One rank's part. x: (b_l, s_l, d), this rank's block of tokens;
    the weights this rank's experts (and, with ``fsdp``, its embed slice)."""
    if fsdp:
        # explicit ZeRO-3: gather the FSDP-sharded dim (D of gate / up at
        # axis 1, of down at axis 2) over 'data', in bf16
        data = mesh.get_group("data")
        w_gate = _all_gather_dim(w_gate.to(ACT_DTYPE), 1, data)
        w_up = _all_gather_dim(w_up.to(ACT_DTYPE), 1, data)
        w_down = _all_gather_dim(w_down.to(ACT_DTYPE), 2, data)
    else:
        w_gate = w_gate.to(ACT_DTYPE)
        w_up = w_up.to(ACT_DTYPE)
        w_down = w_down.to(ACT_DTYPE)
    model = mesh.get_group("model")
    dev = x.device
    e_loc = e_pad // tp
    b_l, s_l, d = x.shape
    t = b_l * s_l
    x2 = x.reshape(t, d)
    gates, eidx = _route(router_w, x2, cfg)            # (t, k)
    k = cfg.top_k
    tok = torch.arange(t, device=dev).repeat_interleave(k)     # (t * k,)
    e_flat = eidx.reshape(-1)
    dest = e_flat // e_loc
    order, slot, valid = _bucket_by(dest, tp, cap_send)
    # send buffers (+1 trash row, dropped before the exchange)
    send_x = torch.zeros((tp * cap_send + 1, d), dtype=ACT_DTYPE, device=dev)
    send_e = torch.zeros((tp * cap_send + 1,), dtype=torch.int32, device=dev)
    send_x[slot] = x2[tok[order]].to(ACT_DTYPE)
    send_e[slot] = (e_flat[order] % e_loc).to(torch.int32)
    t2 = tp * cap_send
    rx = _all_to_all(send_x[:t2], model)
    re = _all_to_all(send_e[:t2], model).long()
    # local re-bucket by expert -> one batched product over experts
    order2, slot2, valid2 = _bucket_by(re, e_loc, cap_local)
    bx = torch.zeros((e_loc * cap_local + 1, d), dtype=ACT_DTYPE, device=dev)
    bx[slot2] = rx[order2]
    bx = bx[:e_loc * cap_local].reshape(e_loc, cap_local, d)
    g = torch.einsum("ecd,edf->ecf", bx, w_gate)
    u = torch.einsum("ecd,edf->ecf", bx, w_up)
    y = torch.einsum("ecf,efd->ecd", silu(g) * u, w_down)
    # un-bucket locally: y back to the received slots
    y2 = torch.zeros((t2, d), dtype=ACT_DTYPE, device=dev)
    y2[order2] = torch.where(
        valid2[:, None],
        y.reshape(-1, d)[torch.clamp(slot2, max=e_loc * cap_local - 1)],
        torch.zeros((), dtype=ACT_DTYPE, device=dev))
    back = _all_to_all(y2, model)
    # gate + scatter-add into the t local tokens
    acc_dt = ACT_DTYPE if L.LOWMEM_NORM else torch.float32
    contrib = torch.where(valid[:, None], back[torch.clamp(slot, max=t2 - 1)],
                          torch.zeros((), dtype=ACT_DTYPE, device=dev))
    g_sorted = gates.reshape(-1)[order]
    out = torch.zeros((t, d), dtype=acc_dt, device=dev)
    out.index_add_(0, tok[order],
                   contrib.to(acc_dt) * g_sorted[:, None].to(acc_dt))
    if stats is not None:
        stats.setdefault("dropped", []).append(
            _dropped(dest, valid, order2, valid2, tp, cap_send, model))
    return out.to(x.dtype).reshape(b_l, s_l, d)


def _dropped(dest, valid, order2, valid2, tp: int, cap_send: int,
             model) -> torch.Tensor:
    """This rank's token copies dropped by capacity: at its send buckets,
    and among the real copies it received at its expert buckets (a
    received bucket's empty slots are expert 0's zero rows, and a drop of
    one of those loses nothing)."""
    sent = torch.bincount(dest, minlength=tp).clamp(max=cap_send)
    got = _all_to_all(sent, model)
    rows = torch.arange(tp * cap_send, device=dest.device)
    real = rows % cap_send < got[rows // cap_send]
    kept = torch.zeros_like(real)
    kept[order2] = valid2
    return (~valid).sum() + (real & ~kept).sum()


def _weight_block(w, spec, mesh, split: set):
    """This rank's block of a weight under ``spec``. Of a DTensor weight
    the gradient comes back partial over each mesh axis of ``split`` (the
    axes that split the tokens) on which the block is whole: each rank's
    tokens give their share, summed where it reaches ``w``."""
    if not isinstance(w, DTensor):
        return local_block(w, spec, mesh)
    pl = placements(spec, mesh)
    grad = [Partial() if isinstance(q, Replicate) and name in split else q
            for q, name in zip(pl, mesh.mesh_dim_names)]
    return w.redistribute(mesh, pl).to_local(grad_placements=grad)


def _moe_ep(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh, *,
            fsdp: bool, cf_send: float, cf_local: float, stats):
    """The ep path over ``mesh``: this rank's token block and weight blocks
    (the JAX shard_map's in_specs), ``_ep_body``, and the output as the
    tokens came: a DTensor with the tokens' spec, or a plain tensor every
    rank holds whole."""
    sizes = mesh_axis_sizes(mesh)
    if "model" not in sizes:
        raise ValueError(f"the expert-parallel MoE exchanges tokens over a "
                         f"'model' mesh axis; this mesh has "
                         f"{tuple(sizes)}")
    tp = sizes["model"]
    e_pad = p["w_gate"].shape[0]
    b, s, d = x.shape
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    dp_eff = dp if b % dp == 0 else 1        # b=1 decode: replicate batch
    sp = tp if s % tp == 0 else 1
    t_local = (b // dp_eff) * (s // sp)
    cap_send = max(8, int(math.ceil(t_local * cfg.top_k * cf_send / tp)))
    cap_local = max(8, int(math.ceil(cap_send * tp * cf_local
                                     / (e_pad // tp))))
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    x_spec = (batch_axes if dp_eff > 1 else None,
              "model" if sp > 1 else None, None)
    fs = "data" if fsdp else None
    w_spec = ("model", fs, None)
    split = set(batch_axes if dp_eff > 1 else ()) | (
        {"model"} if sp > 1 else set())
    y = _ep_body(local_block(x, x_spec, mesh),
                 _weight_block(p["router"], (None, None), mesh, split),
                 _weight_block(p["w_gate"], w_spec, mesh, split),
                 _weight_block(p["w_up"], w_spec, mesh, split),
                 _weight_block(p["w_down"], ("model", None, fs), mesh,
                               split),
                 cfg=cfg, tp=tp, e_pad=e_pad, cap_send=cap_send,
                 cap_local=cap_local, fsdp=fsdp, mesh=mesh, stats=stats)
    y = DTensor.from_local(y, mesh, placements(x_spec, mesh),
                           run_check=False)
    return y if isinstance(x, DTensor) else y.full_tensor()


def moe_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "auto", fsdp: bool = False,
              cf_send: float = 1.25, cf_local: float = 1.25,
              stats: Optional[dict] = None) -> torch.Tensor:
    """MoE sublayer (no norm / residual). x: (B, S, D), the same on every
    rank of the current mesh (or a DTensor on it).

    ``impl``: "dense", "ep" (needs a mesh with a 'model' axis) or "auto"
    (ep over a model axis wider than 1, else dense). ``fsdp``, ``cf_send``
    and ``cf_local`` steer the ep path. ``stats``, a dict, receives under
    "dropped" one count a call (a 0-dim tensor, not synced) of this rank's
    token copies dropped by the ep path's capacities."""
    if impl not in ("auto", "dense", "ep"):
        raise ValueError(f"moe impl {impl!r}: one of 'auto', 'dense', 'ep'")
    mesh = current_mesh()
    tp = 1 if mesh is None else mesh_axis_sizes(mesh).get("model", 1)
    if impl == "ep" or (impl == "auto" and tp > 1):
        if mesh is None:
            raise MeshRequiredError(
                "the expert-parallel MoE (impl='ep') needs a mesh: run it "
                "under distributed.sharding_ctx(mesh), e.g. "
                "launch.mesh.make_host_mesh() on one card")
        y = _moe_ep(p, cfg, x, mesh, fsdp=fsdp, cf_send=cf_send,
                    cf_local=cf_local, stats=stats)
    else:
        y = _moe_dense(p, cfg, x)
    if cfg.n_shared_experts:
        y = y + mlp_block(p["shared"], x, act=silu)
    return y
