"""What both plain references share: the GCN's graph worked out again from
the benchmark's COO snapshots, laid out for B streams stepped together,
and the lower precision of the control.

For each snapshot the active nodes are the sorted unique global ids of its
edge ends, renumbered 0..n-1 in that order; every COO edge (s, d) becomes
two directed edges s -> d and d -> s with the edge's features, and every
node gets a self-loop with zero features; coef(u -> v) = 1 / sqrt(deg(u)
deg(v)) over in-degrees of that multigraph (A + I, duplicates counted).

Layout: stream b's node i sits at row ``b * n_pad + i`` of a (B * n_pad,
...) block; its global id g at row ``b * G + g`` of a (B * G, ...) store.
Imports numpy and torch only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Steps:
    """Every step's graph for B streams, flat on the device; step t's
    entries are ``[off[t], off[t + 1])`` of each flat tensor."""

    node_off: list      # (T_max + 1,) offsets into the node tensors
    edge_off: list      # (T_max + 1,) offsets into the edge tensors
    node_pos: torch.Tensor   # block row b * n_pad + i
    node_gid: torch.Tensor   # store row b * G + g
    out_pos: torch.Tensor    # row of the flat (sum_b T_b * n_pad) output
    src: torch.Tensor        # block rows of each directed edge's ends
    dst: torch.Tensor
    coef: torch.Tensor       # float32
    ef: torch.Tensor         # (E, edge_dim) float32, zeros on self-loops
    live: torch.Tensor       # (T_max, B) bool: step t of stream b exists
    out_base: list           # (B,) first row of stream b's outputs
    B: int
    T: list                  # (B,) lengths


def normalise(src: np.ndarray, dst: np.ndarray, ef: np.ndarray):
    """(active global ids, local src, local dst, coef, edge features) of
    one snapshot, self-loops and reverse edges included."""
    nodes = np.unique(np.concatenate([src, dst]))
    n = nodes.size
    s = np.searchsorted(nodes, src)
    d = np.searchsorted(nodes, dst)
    loops = np.arange(n)
    s2 = np.concatenate([s, d, loops])
    d2 = np.concatenate([d, s, loops])
    ef2 = np.concatenate([ef, ef, np.zeros((n, ef.shape[1]), np.float32)])
    deg = np.bincount(d2, minlength=n).astype(np.float64)
    coef = (1.0 / np.sqrt(deg[s2] * deg[d2])).astype(np.float32)
    return nodes, s2, d2, coef, ef2


def prepare(streams: list, n_pad: int, G: int, device) -> Steps:
    """The graphs of ``streams`` (harness ``Stream`` objects) stepped
    together: step t holds snapshot t of every stream longer than t."""
    B = len(streams)
    T = [len(s.snaps) for s in streams]
    out_base = np.concatenate([[0], np.cumsum([t * n_pad for t in T])])
    cols = {k: [] for k in ("pos", "gid", "out", "src", "dst", "coef", "ef")}
    node_off, edge_off = [0], [0]
    live = np.zeros((max(T), B), bool)
    for t in range(max(T)):
        n_t = e_t = 0
        for b, s in enumerate(streams):
            if t >= T[b]:
                continue
            live[t, b] = True
            snap = s.snaps[t]
            nodes, s2, d2, coef, ef2 = normalise(snap.src, snap.dst, snap.ef)
            local = np.arange(nodes.size)
            cols["pos"].append(b * n_pad + local)
            cols["gid"].append(b * G + nodes)
            cols["out"].append(out_base[b] + t * n_pad + local)
            cols["src"].append(b * n_pad + s2)
            cols["dst"].append(b * n_pad + d2)
            cols["coef"].append(coef)
            cols["ef"].append(ef2)
            n_t += nodes.size
            e_t += s2.size
        node_off.append(node_off[-1] + n_t)
        edge_off.append(edge_off[-1] + e_t)

    def dev(key, dtype):
        return torch.as_tensor(np.concatenate(cols[key])).to(device, dtype)

    return Steps(node_off, edge_off, dev("pos", torch.long),
                 dev("gid", torch.long), dev("out", torch.long),
                 dev("src", torch.long), dev("dst", torch.long),
                 dev("coef", torch.float32), dev("ef", torch.float32),
                 torch.as_tensor(live).to(device), list(out_base[:-1]), B, T)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest): the operands a
    tensor core's TF32 product reads."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a, b, low: bool):
    """``a @ b`` in float32, or with ``low`` on TF32-rounded operands (the
    control's precision); the product accumulates in float32 either way."""
    return tf32(a) @ tf32(b) if low else a @ b


def split_outputs(flat: torch.Tensor, steps: Steps, n_pad: int) -> list:
    """The flat output rows as one (T_b, n_pad, width) tensor a stream."""
    return [flat[base:base + t * n_pad].view(t, n_pad, -1)
            for base, t in zip(steps.out_base, steps.T)]
