"""Plain PyTorch reference of EvolveGCN-O (Pareja et al.,
arXiv:1902.10191), DGNN-Booster's V1 base model (arXiv:2304.06831), in
float32 with TF32 off.

Each GCN layer l has a weight W_l that a matrix GRU evolves, W_l's columns
being the GRU's batch and W_l both its input and its hidden state:
W_l^t = GRU_l(W_l^{t-1}). The session starts from the evolved W_l^1 =
GRU_l(W_l) and, per snapshot t, with the graph of ``_common.normalise``:

    agg[v] = sum_(u->v) coef(u, v) * (x[u] + ef(u->v) @ w_edge_l)
    x' = agg @ W_l^t + b_l     (ReLU between layers, the last linear)

then evolves every W_l once more, so its state after T snapshots is
W_l^{T+1}. Padding rows of an output are zero. Imports numpy and torch
only; the parameters are the ones the benchmark made, in the port's
layout.
"""
from __future__ import annotations

import math

import torch

from bench.reference import _common as C


def layer_dims(w: dict) -> list:
    """(in, out) width of each GCN layer: in_dim -> hidden ... -> out_dim."""
    dims, din = [], w["in_dim"]
    for l in range(w["n_gnn_layers"]):
        dout = w["out_dim"] if l == w["n_gnn_layers"] - 1 else w["hidden"]
        dims.append((din, dout))
        din = dout
    return dims


def make_params(w: dict, gen: torch.Generator, device) -> dict:
    """Random parameters in the port's layout from one draw of ``gen``."""
    de = w["edge_dim"]
    shapes = []
    for din, dout in layer_dims(w):
        shapes += [(din, dout), (dout,), (de, din),
                   (din, 3 * din), (din, 3 * din), (3 * din,)]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=gen,
                       device=device)
    parts = [v.view(s) for v, s in zip(
        flat.split([math.prod(s) for s in shapes]), shapes)]
    gcn, gru = [], []
    for l, (din, dout) in enumerate(layer_dims(w)):
        wl, bl, we, gx, gh, gb = parts[6 * l:6 * l + 6]
        gcn.append({"w": wl / math.sqrt(din), "b": bl * 0.1,
                    "w_edge": we / math.sqrt(de)})
        glorot = math.sqrt(2.0 / (din + 3 * din))
        gru.append({"wx": gx * glorot, "wh": gh * glorot, "b": gb * 0.1})
    return {"gcn": gcn, "gru": gru}


def evolve(g: dict, w: torch.Tensor, low: bool) -> torch.Tensor:
    """One matrix-GRU step of (..., din, dout) weights."""
    wt = w.transpose(-1, -2)
    rx, zx, nx = (C.matmul(wt, g["wx"], low) + g["b"]).chunk(3, dim=-1)
    rh, zh, nh = C.matmul(wt, g["wh"], low).chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return ((1.0 - z) * n + z * wt).transpose(-1, -2)


@torch.no_grad()
def reference(params: dict, streams: list, n_pad: int, G: int, device,
              low: bool = False):
    """Every stream from a fresh state. Returns ([outputs (T_b, n_pad, out)
    a stream], [final state a stream]); ``low`` computes every product on
    TF32-rounded operands (the control)."""
    steps = C.prepare(streams, n_pad, G, device)
    gcn, gru = params["gcn"], params["gru"]
    B = steps.B
    din0 = gcn[0]["w"].shape[0]
    feat = torch.zeros(B * G, din0, device=device)
    for b, s in enumerate(streams):
        feat[b * G:b * G + s.n_global] = torch.as_tensor(s.feat).to(device)
    ws = [evolve(g, p["w"].expand(B, *p["w"].shape), low)
          for p, g in zip(gcn, gru)]
    out_flat = torch.zeros(sum(steps.T) * n_pad, gcn[-1]["w"].shape[1],
                           device=device)
    for t in range(len(steps.node_off) - 1):
        n0, n1 = steps.node_off[t], steps.node_off[t + 1]
        e0, e1 = steps.edge_off[t], steps.edge_off[t + 1]
        pos, gid = steps.node_pos[n0:n1], steps.node_gid[n0:n1]
        src, dst = steps.src[e0:e1], steps.dst[e0:e1]
        coef = steps.coef[e0:e1, None]
        mask = torch.zeros(B * n_pad, 1, device=device)
        mask[pos] = 1.0
        x = torch.zeros(B * n_pad, din0, device=device)
        x[pos] = feat[gid]
        for l, (p, w) in enumerate(zip(gcn, ws)):
            em = C.matmul(steps.ef[e0:e1], p["w_edge"], low)
            agg = torch.zeros_like(x).index_add_(0, dst, (x[src] + em) * coef)
            y = C.matmul(agg.view(B, n_pad, -1), w, low) + p["b"]
            if l < len(gcn) - 1:
                y = torch.relu(y)
            x = y.reshape(B * n_pad, -1) * mask
        out_flat[steps.out_pos[n0:n1]] = x[pos]
        on = steps.live[t][:, None, None]
        ws = [torch.where(on, evolve(g, w, low), w) for g, w in zip(gru, ws)]
    return (C.split_outputs(out_flat, steps, n_pad),
            [{f"w{l}": w[b] for l, w in enumerate(ws)} for b in range(B)])


def port_state(state: dict, b=None) -> dict:
    """The port's session state (stream ``b`` of a batched one) under the
    names ``reference`` gives its states."""
    return {f"w{l}": w if b is None else w[b]
            for l, w in enumerate(state["weights"])}
