"""Plain PyTorch reference of GCRN-M2: the graph-convolutional LSTM
(Seo et al., arXiv:1612.07659), DGNN-Booster's V2 base model
(arXiv:2304.06831), in float32 with TF32 off.

Per snapshot, with the graph of ``_common.normalise``:

    agg_x[v] = sum_(u->v) coef(u, v) * (x[u] + ef(u->v) @ w_edge)
    agg_h[v] = sum_(u->v) coef(u, v) * h^{t-1}[u]
    i, f, g, o = agg_x @ wx + agg_h @ wh + b
    c^t = sigmoid(f) c^{t-1} + sigmoid(i) tanh(g),  h^t = sigmoid(o) tanh(c^t)
    out^t = h^t @ head_w + head_b

h and c live in a per-stream store of G rows, one per global node id:
a step reads its active nodes' rows (zero until first written) and writes
them back. Padding rows of an output are zero. Imports numpy and torch
only; the parameters are the ones the benchmark made, in the port's
layout.
"""
from __future__ import annotations

import math

import torch

from bench.reference import _common as C


def make_params(w: dict, gen: torch.Generator, device) -> dict:
    """Random parameters in the port's layout from one draw of ``gen``."""
    din, H, out, de = w["in_dim"], w["hidden"], w["out_dim"], w["edge_dim"]
    shapes = {"wx": (din, 4 * H), "wh": (H, 4 * H), "b": (4 * H,),
              "head_w": (H, out), "head_b": (out,), "w_edge": (de, din)}
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, device=device)
    p = {k: v.view(shapes[k]) for k, v in zip(
        shapes, flat.split([math.prod(s) for s in shapes.values()]))}
    b = p["b"] * 0.1
    b[H:2 * H] += 1.0  # forget-gate bias
    return {"lstm": {"wx": p["wx"] * math.sqrt(2.0 / (din + 4 * H)),
                     "wh": p["wh"] * math.sqrt(2.0 / (H + 4 * H)),
                     "b": b},
            "head": {"w": p["head_w"] / math.sqrt(H),
                     "b": p["head_b"] * 0.1},
            "w_edge": p["w_edge"] / math.sqrt(de)}


@torch.no_grad()
def reference(params: dict, streams: list, n_pad: int, G: int, device,
              low: bool = False):
    """Every stream from a fresh state. Returns ([outputs (T_b, n_pad, out)
    a stream], [final state a stream]); ``low`` computes every product on
    TF32-rounded operands (the control)."""
    steps = C.prepare(streams, n_pad, G, device)
    lstm, head = params["lstm"], params["head"]
    din, H = lstm["wx"].shape[0], lstm["wh"].shape[0]
    B = steps.B
    feat = torch.zeros(B * G, din, device=device)
    for b, s in enumerate(streams):
        feat[b * G:b * G + s.n_global] = torch.as_tensor(s.feat).to(device)
    h = torch.zeros(B * G, H, device=device)
    c = torch.zeros(B * G, H, device=device)
    out_flat = torch.zeros(sum(steps.T) * n_pad, head["w"].shape[1],
                           device=device)
    for t in range(len(steps.node_off) - 1):
        n0, n1 = steps.node_off[t], steps.node_off[t + 1]
        e0, e1 = steps.edge_off[t], steps.edge_off[t + 1]
        pos, gid = steps.node_pos[n0:n1], steps.node_gid[n0:n1]
        src, dst = steps.src[e0:e1], steps.dst[e0:e1]
        coef = steps.coef[e0:e1, None]
        xb = torch.zeros(B * n_pad, din, device=device)
        xb[pos] = feat[gid]
        hb = torch.zeros(B * n_pad, H, device=device)
        hb[pos] = h[gid]
        em = C.matmul(steps.ef[e0:e1], params["w_edge"], low)
        agg_x = torch.zeros_like(xb).index_add_(0, dst, (xb[src] + em) * coef)
        agg_h = torch.zeros_like(hb).index_add_(0, dst, hb[src] * coef)
        gates = (C.matmul(agg_x[pos], lstm["wx"], low)
                 + C.matmul(agg_h[pos], lstm["wh"], low) + lstm["b"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c[gid] + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h[gid], c[gid] = h_new, c_new
        out_flat[steps.out_pos[n0:n1]] = (C.matmul(h_new, head["w"], low)
                                          + head["b"])
    hs, cs = h.view(B, G, H), c.view(B, G, H)
    return (C.split_outputs(out_flat, steps, n_pad),
            [{"h": hs[b], "c": cs[b]} for b in range(B)])


def port_state(state: dict, b=None) -> dict:
    """The port's session state (stream ``b`` of a batched one) under the
    names ``reference`` gives its states."""
    if b is None:
        return {"h": state["h"], "c": state["c"]}
    return {"h": state["h"][b], "c": state["c"][b]}
