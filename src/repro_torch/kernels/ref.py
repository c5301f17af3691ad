"""Plain PyTorch versions of the kernels (the port's force-ref path).

These are written from the math, op by op, with no custom kernel: the
ground truth the CUDA kernels (the ELL SpMM, the V2 fused steps, the
stream engines) are held to on the card, and what the kernel wrappers run
for tensors that lie on the CPU.

Padded ELL layout, as the kernels read it:
  neigh_idx  (N, K) int32 — local source node per (dst, slot); 0 on padding
  neigh_coef (N, K) f32   — GCN normalisation; 0 on padding (kills the lane)
  neigh_eidx (N, K) int32 — edge index for edge-feature lookup; 0 on padding

The stream versions run a Python loop over T with the batch written out as
a leading B axis; the solo versions are the B = 1 case.
"""
from __future__ import annotations

import torch


def ell_gather_msgs(neigh_idx, neigh_coef, neigh_eidx, x, edge_msg=None):
    """(..., N, K, D) messages coef * (x[src] + edge_msg[eidx]); any
    leading batch axes are shared by every argument."""
    g = _take_rows(x, neigh_idx)
    if edge_msg is not None:
        g = g + _take_rows(edge_msg, neigh_eidx)
    return g * neigh_coef[..., None]


def ell_spmm(neigh_idx, neigh_coef, neigh_eidx, x, edge_msg=None):
    """agg[v] = sum_k coef[v,k] * (x[idx[v,k]] + emsg[eidx[v,k]])."""
    return ell_gather_msgs(neigh_idx, neigh_coef, neigh_eidx, x,
                           edge_msg).sum(dim=-2)


def evolve_edge_terms(neigh_eidx, neigh_coef, edge_feat, w_edges):
    """EvolveGCN-O's per-layer edge terms sum_k coef[v,k] * (edge_feat @
    w_edge_l)[eidx[v,k]], (..., n, din_l) each, for the layers' ``w_edges``
    (De, din_l). The term is linear in the edge features, so they are
    aggregated once (width De) and each layer's w_edge applies to that
    aggregate.

    Both sums run as elementwise adds in a fixed order (lane by lane, then
    edge feature by edge feature), so a snapshot's term has the same bits
    whatever the batch's B and T: a reduction kernel's or a GEMM's
    summation order follows the tensor's shape (on an H100, ``agg @
    w_edge`` of a T 2 chunk and of a T 8 chunk differed in the last bit).
    The edge-term kernel (csrc/edge_terms.cu) keeps this order."""
    msgs = ell_gather_msgs(neigh_eidx, neigh_coef, neigh_eidx, edge_feat)
    agg = msgs[..., 0, :]
    for k in range(1, msgs.shape[-2]):
        agg = agg + msgs[..., k, :]
    terms = []
    for w in w_edges:
        term = agg[..., :1] * w[0]
        for d in range(1, w.shape[0]):
            term = term + agg[..., d:d + 1] * w[d]
        terms.append(term)
    return terms


def fused_gru(x, h, wx, wh, b):
    gx = x @ wx + b
    gh = h @ wh
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1.0 - z) * n + z * h


def fused_lstm(x, h, c, wx, wh, b):
    gates = x @ wx + h @ wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def dgnn_fused_step(neigh_idx, neigh_coef, neigh_eidx, x, h, c, wx, wh, b,
                    edge_msg=None):
    """GCRN-M2 step: ELL-aggregate x and h, gate transform, LSTM update."""
    agg_x = ell_spmm(neigh_idx, neigh_coef, neigh_eidx, x, edge_msg)
    agg_h = ell_spmm(neigh_idx, neigh_coef, neigh_eidx, h, None)
    return fused_lstm(agg_x, agg_h, c, wx, wh, b)


def stacked_fused_step(neigh_idx, neigh_coef, neigh_eidx, x, h, w_gcn, b_gcn,
                       wx, wh, b, edge_msg=None):
    """Stacked-DGNN step: ELL-aggregate, linear node transform, GRU
    against each node's own h."""
    agg = ell_spmm(neigh_idx, neigh_coef, neigh_eidx, x, edge_msg)
    return fused_gru(agg @ w_gcn + b_gcn, h, wx, wh, b)


def _take_rows(table, index):
    """table (..., R, D) gathered at index (..., N, K) -> (..., N, K, D),
    the leading axes of both shared."""
    lead = index.shape[:-2]
    n, k = index.shape[-2:]
    flat = index.reshape(*lead, n * k, 1).long()
    g = torch.gather(table, -2, flat.expand(*lead, n * k, table.shape[-1]))
    return g.reshape(*lead, n, k, table.shape[-1])


def _gather_rows(store, renumber, mask):
    """(B, G, H) store rows at (B, n) renumber; -1 reads row 0, masked."""
    safe = torch.where(renumber >= 0, renumber, 0).long()
    rows = torch.gather(store, 1, safe[..., None].expand(*safe.shape,
                                                          store.shape[-1]))
    return rows * mask[..., None]


def _scatter_rows_(store, renumber, val):
    """In place: store[b, renumber[b, v]] = val[b, v] where renumber >= 0
    (-1 drops the row)."""
    bi, vi = torch.nonzero(renumber >= 0, as_tuple=True)
    store[bi, renumber[bi, vi].long()] = val[bi, vi]


def gcrn_stream_batched_ref(neigh_idx, neigh_coef, neigh_eidx, node_feat,
                            renumber, node_mask, h0, c0, wx, wh, b,
                            edge_msg=None):
    """B independent GCRN streams: (B, T, n, ...) snapshot arrays, (B, G, H)
    state stores. Returns (per-step h (B, T, n, H), final h, final c)."""
    h_store, c_store = h0.clone(), c0.clone()
    outs = []
    for t in range(neigh_idx.shape[1]):
        ren, mask = renumber[:, t], node_mask[:, t]
        h = _gather_rows(h_store, ren, mask)
        c = _gather_rows(c_store, ren, mask)
        em = None if edge_msg is None else edge_msg[:, t]
        h_new, c_new = dgnn_fused_step(neigh_idx[:, t], neigh_coef[:, t],
                                       neigh_eidx[:, t], node_feat[:, t],
                                       h, c, wx, wh, b, em)
        m = mask[..., None]
        h_new, c_new = h_new * m, c_new * m
        _scatter_rows_(h_store, ren, h_new)
        _scatter_rows_(c_store, ren, c_new)
        outs.append(h_new)
    return torch.stack(outs, dim=1), h_store, c_store


def gcrn_stream_ref(neigh_idx, neigh_coef, neigh_eidx, node_feat, renumber,
                    node_mask, h0, c0, wx, wh, b, edge_msg=None):
    """One GCRN stream: (T, n, ...) arrays, (G, H) stores. Returns
    (per-step h (T, n, H), final h store, final c store)."""
    em = None if edge_msg is None else edge_msg[None]
    outs, hT, cT = gcrn_stream_batched_ref(
        neigh_idx[None], neigh_coef[None], neigh_eidx[None], node_feat[None],
        renumber[None], node_mask[None], h0[None], c0[None], wx, wh, b, em)
    return outs[0], hT[0], cT[0]


def stacked_stream_batched_ref(neigh_idx, neigh_coef, neigh_eidx, node_feat,
                               renumber, node_mask, h0, w_gcn, b_gcn, wx, wh,
                               b, edge_msg=None):
    """B independent stacked streams: the last GCN layer and the GRU per
    step over (B, G, H) h stores. Returns (per-step h (B, T, n, H), final
    h)."""
    h_store = h0.clone()
    outs = []
    for t in range(neigh_idx.shape[1]):
        ren, mask = renumber[:, t], node_mask[:, t]
        h = _gather_rows(h_store, ren, mask)
        em = None if edge_msg is None else edge_msg[:, t]
        h_new = stacked_fused_step(neigh_idx[:, t], neigh_coef[:, t],
                                   neigh_eidx[:, t], node_feat[:, t], h,
                                   w_gcn, b_gcn, wx, wh, b, em)
        h_new = h_new * mask[..., None]
        _scatter_rows_(h_store, ren, h_new)
        outs.append(h_new)
    return torch.stack(outs, dim=1), h_store


def stacked_stream_ref(neigh_idx, neigh_coef, neigh_eidx, node_feat,
                       renumber, node_mask, h0, w_gcn, b_gcn, wx, wh, b,
                       edge_msg=None):
    """One stacked stream: (T, n, ...) arrays, (G, H) store. Returns
    (per-step h (T, n, H), final h store)."""
    em = None if edge_msg is None else edge_msg[None]
    outs, hT = stacked_stream_batched_ref(
        neigh_idx[None], neigh_coef[None], neigh_eidx[None], node_feat[None],
        renumber[None], node_mask[None], h0[None], w_gcn, b_gcn, wx, wh, b,
        em)
    return outs[0], hT[0]


def evolve_stream_batched_ref(neigh_idx, neigh_coef, node_feat, node_mask,
                              live, weights0, b_gcn, gru_wx, gru_wh, gru_b,
                              edge_aggs=None):
    """B independent EvolveGCN streams: (B, T, n, ...) arrays, per-layer
    (B, din_l, dout_l) evolving weights; GRU params and GCN biases shared.

    Per step t the L-layer GCN consumes the current weights (agg @ W_l +
    b_l, ReLU between layers, masked every layer; ``edge_aggs`` (B, T, L,
    n, D), the square layout the edge-term kernel writes, holds layer l's
    pre-aggregated edge term in its first din_l columns), then on live
    steps the matrix-GRU evolves every layer's weight for step t+1.
    Returns (per-step outputs (B, T, n, out_dim), final weights tuple)."""
    ws = list(weights0)
    outs = []
    for t in range(neigh_idx.shape[1]):
        idx, coef = neigh_idx[:, t], neigh_coef[:, t]
        m = node_mask[:, t][..., None]
        x = node_feat[:, t]
        for i, w in enumerate(ws):
            agg = (_take_rows(x, idx) * coef[..., None]).sum(dim=-2)
            if edge_aggs is not None:
                agg = agg + edge_aggs[:, t, i, :, :w.shape[-2]]
            h = agg @ w + b_gcn[i]
            if i < len(ws) - 1:
                h = torch.relu(h)
            x = h * m
        outs.append(x)
        on = (live[:, t] > 0)[:, None, None]
        ws = [torch.where(on, fused_gru(w.transpose(1, 2), w.transpose(1, 2),
                                        wx, wh, bb).transpose(1, 2), w)
              for w, wx, wh, bb in zip(ws, gru_wx, gru_wh, gru_b)]
    return torch.stack(outs, dim=1), tuple(ws)


def evolve_stream_ref(neigh_idx, neigh_coef, node_feat, node_mask, live,
                      weights0, b_gcn, gru_wx, gru_wh, gru_b, edge_aggs=None):
    """One EvolveGCN stream: (T, n, ...) arrays, per-layer (din_l, dout_l)
    weights. Returns (per-step outputs (T, n, out_dim), final weights)."""
    outs, wT = evolve_stream_batched_ref(
        neigh_idx[None], neigh_coef[None], node_feat[None], node_mask[None],
        live[None], [w[None] for w in weights0], b_gcn, gru_wx, gru_wh,
        gru_b, None if edge_aggs is None else edge_aggs[None])
    return outs[0], tuple(w[0] for w in wT)


def tgn_stream_batched_ref(neigh_idx, neigh_coef, neigh_ts, node_feat,
                           renumber, node_mask, mem0, freq, w_in, wx, wh, b):
    """B independent TGN event streams: (B, T, n, ...) padded event batches
    (graph/events.pad_event_block), (B, G, H) node-memory stores;
    frequencies, input projection and GRU params shared.

    Per event batch every touched node aggregates its event partners' t-1
    memory and the time encoding cos(ts * freq) of its events (coef
    weighted, so dead lanes add exactly zero), feeds the GRU against its
    own t-1 memory row, and the new memory is scattered back at its
    renumber row only: untouched rows carry over. Returns (per-batch memory
    outputs (B, T, n, H), final memory store)."""
    store = mem0.clone()
    outs = []
    for t in range(neigh_idx.shape[1]):
        ren, mask = renumber[:, t], node_mask[:, t]
        coef = neigh_coef[:, t][..., None]
        mem = _gather_rows(store, ren, mask)
        agg_m = (_take_rows(mem, neigh_idx[:, t]) * coef).sum(dim=-2)
        enc = torch.cos(neigh_ts[:, t][..., None] * freq)
        agg_e = (enc * coef).sum(dim=-2)
        inp = node_feat[:, t] @ w_in + agg_m + agg_e
        m_new = fused_gru(inp, mem, wx, wh, b) * mask[..., None]
        _scatter_rows_(store, ren, m_new)
        outs.append(m_new)
    return torch.stack(outs, dim=1), store


def tgn_stream_ref(neigh_idx, neigh_coef, neigh_ts, node_feat, renumber,
                   node_mask, mem0, freq, w_in, wx, wh, b):
    """One TGN event stream: (T, n, ...) event batches, (G, H) memory
    store. Returns (per-batch memory outputs (T, n, H), final store)."""
    outs, memT = tgn_stream_batched_ref(
        neigh_idx[None], neigh_coef[None], neigh_ts[None], node_feat[None],
        renumber[None], node_mask[None], mem0[None], freq, w_in, wx, wh, b)
    return outs[0], memT[0]


def static_gcn_stream_batched_ref(neigh_idx, neigh_coef, node_feat,
                                  node_mask, weights, b_gcn,
                                  edge_aggs=None):
    """B batches of (T, n, ...) independent static snapshots (no carry)
    through the L-layer GCN: agg @ W_l + b_l, ReLU between layers, masked
    every layer, the last layer linear; ``edge_aggs[l]`` (B, T, n, din_l)
    is layer l's pre-aggregated edge term. Weights are shared (params, not
    state). T is 1 on the kernel path; here any T works, the steps being
    independent. Returns the 1-tuple (outputs (B, T, n, out_dim),)."""
    x = node_feat
    m = node_mask[..., None]
    for i, (w, bb) in enumerate(zip(weights, b_gcn)):
        agg = (_take_rows(x, neigh_idx) * neigh_coef[..., None]).sum(dim=-2)
        if edge_aggs is not None:
            agg = agg + edge_aggs[i]
        h = agg @ w + bb
        if i < len(weights) - 1:
            h = torch.relu(h)
        x = h * m
    return (x,)


def static_gcn_stream_ref(neigh_idx, neigh_coef, node_feat, node_mask,
                          weights, b_gcn, edge_aggs=None):
    """(T, n, ...) independent static snapshots through the L-layer GCN.
    Returns the 1-tuple (outputs (T, n, out_dim),)."""
    ea = None if edge_aggs is None else [a[None] for a in edge_aggs]
    (outs,) = static_gcn_stream_batched_ref(
        neigh_idx[None], neigh_coef[None], node_feat[None], node_mask[None],
        weights, b_gcn, ea)
    return (outs[0],)
