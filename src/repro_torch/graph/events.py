"""Static-shape padding of timestamped EVENT BATCHES (the "event" temporal
contract).

An event-driven temporal GNN (TGN/TGAT lineage) consumes a stream of
interaction events ``(u, v, t)`` instead of graph snapshots. Consecutive
events are grouped into batches; each batch pads into the same ELL row
layout the dense families use — one row per TOUCHED node, lanes carrying
that node's events in the batch — so an event stream rides the stream
engine's (T, n, k) layout, with ragged ``lengths`` counting event batches.

The symmetric-lane convention: event ``(u, v, t)`` writes lane ``(v, t)``
on row ``u`` and lane ``(u, t)`` on row ``v`` (both endpoints observe the
event), so every lane with a nonzero coef references a touched (mask-1) row
of the same batch. Dead lanes carry coef 0, so their zero-filled timestamps
contribute exactly zero to the time encoding.

``PaddedEventBlock`` holds host numpy arrays; ``.to(device)`` gives the
same block as torch tensors on a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PaddedEventBlock:
    """Device-ready batch of timestamped events, laid out like the ELL half
    of ``PaddedSnapshot`` so the engine's node tiling applies unchanged;
    ``neigh_ts`` rides the slot dense families use for edge indices.
    Leaves may carry leading (T,) or (B, T) axes once stacked."""

    neigh_idx: object   # (n_pad, k_max) int32 local partner per event
    neigh_coef: object  # (n_pad, k_max) f32 1/deg; 0 on padding
    neigh_ts: object    # (n_pad, k_max) f32 event timestamps; 0 on padding
    node_feat: object   # (n_pad, Din) f32 touched-node features
    node_mask: object   # (n_pad,) f32; 1 for touched nodes
    renumber: object    # (n_pad,) int32 local->global (-1 on padding)
    n_nodes: object     # () int32 touched nodes
    n_events: object    # () int32 real events

    @property
    def n_pad(self) -> int:
        return self.node_feat.shape[-2]

    @property
    def k_max(self) -> int:
        return self.neigh_idx.shape[-1]

    def to(self, device) -> "PaddedEventBlock":
        """The same block as torch tensors on ``device``."""
        def conv(a):
            t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
            return t.to(device)

        return PaddedEventBlock(**{f.name: conv(getattr(self, f.name))
                                   for f in dataclasses.fields(self)})


def pad_event_block(src, dst, ts, feat_table, n_pad: int,
                    k_max: int) -> PaddedEventBlock:
    """Pad one batch of events ``(src[i], dst[i], ts[i])`` into the
    (n_pad, k_max) ELL layout over the batch's TOUCHED nodes.

    ``feat_table`` is the global node-feature store (G, Din); touched nodes
    (the union of both endpoints) renumber into rows 0..n-1 in sorted
    global-id order. A row's lanes are weighted 1/deg (the mean over the
    node's events in the batch). Raises when the batch overflows the
    bucket — more touched nodes than ``n_pad``, a node with more events
    than ``k_max`` — or holds a self-loop event.
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    ts = np.asarray(ts, np.float32)
    if not (src.shape == dst.shape == ts.shape and src.ndim == 1):
        raise ValueError(f"event batch arrays must be 1-D and congruent: "
                         f"src {src.shape}, dst {dst.shape}, ts {ts.shape}")
    if np.any(src == dst):
        raise ValueError("self-loop events (src == dst) are not "
                         "interactions; drop them before padding")
    touched = np.unique(np.concatenate([src, dst]))
    n = int(touched.shape[0])
    if n > n_pad:
        raise ValueError(f"event batch touches {n} nodes; bucket n_pad="
                         f"{n_pad}")
    local = {int(g): i for i, g in enumerate(touched)}

    idx = np.zeros((n_pad, k_max), np.int32)
    coef = np.zeros((n_pad, k_max), np.float32)
    tsl = np.zeros((n_pad, k_max), np.float32)
    deg = np.zeros(n_pad, np.int32)
    for u, v, t in zip(src, dst, ts):  # symmetric: both endpoints observe
        for a, b in ((int(u), int(v)), (int(v), int(u))):
            i = local[a]
            if deg[i] >= k_max:
                raise ValueError(f"node {a} has more than k_max={k_max} "
                                 "events in this batch")
            idx[i, deg[i]] = local[b]
            tsl[i, deg[i]] = t
            deg[i] += 1
    rows = deg > 0
    coef[rows] = (np.arange(k_max)[None, :]
                  < deg[rows, None]) / deg[rows, None]

    nf = np.zeros((n_pad, feat_table.shape[1]), np.float32)
    nf[:n] = np.asarray(feat_table)[touched]
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    ren = np.full(n_pad, -1, np.int32)
    ren[:n] = touched
    return PaddedEventBlock(
        neigh_idx=idx, neigh_coef=coef, neigh_ts=tsl,
        node_feat=nf, node_mask=mask, renumber=ren,
        n_nodes=np.int32(n), n_events=np.int32(src.shape[0]))


def unpad_event_block(blk: PaddedEventBlock):
    """The event multiset of a padded block as sorted ``(src, dst, ts)``
    arrays with ``src < dst`` (the undirected canonical form: padding adds
    symmetric lanes, so each event is emitted once, from its smaller
    global-id endpoint)."""
    idx = np.asarray(blk.neigh_idx)
    coef = np.asarray(blk.neigh_coef)
    tsl = np.asarray(blk.neigh_ts)
    ren = np.asarray(blk.renumber)
    events = []
    for i in range(idx.shape[0]):
        if ren[i] < 0:
            continue
        for l in range(idx.shape[1]):
            if coef[i, l] == 0.0:
                continue
            g_other = int(ren[idx[i, l]])
            if int(ren[i]) < g_other:
                events.append((int(ren[i]), g_other, float(tsl[i, l])))
    events.sort()
    if not events:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    s, d, t = zip(*events)
    return (np.asarray(s, np.int32), np.asarray(d, np.int32),
            np.asarray(t, np.float32))
