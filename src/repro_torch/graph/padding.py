"""Static-shape padding of snapshots for the device.

Every snapshot is padded into one (n_pad, e_pad, k_max) bucket and carries
masks, so a whole stream stacks into dense (T, ...) arrays and the device
code never branches on a snapshot's size. Padded edges point at a
dedicated sink row with coef 0.

``PaddedSnapshot`` holds host numpy arrays; ``.to(device)`` gives the
same snapshot as torch tensors on a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graph.csr import LocalSnapshot, to_ell


def round_up(n: int, m: int) -> int:
    """Round ``n`` up to the next multiple of ``m``."""
    return ((n + m - 1) // m) * m


@dataclass
class PaddedSnapshot:
    """Device-ready snapshot: every array has a static shape. Leaves may
    carry leading (T,) or (B, T) axes once stacked."""

    # COO path
    src: object        # (e_pad,) int32
    dst: object        # (e_pad,) int32
    coef: object       # (e_pad,) f32; 0 on padding
    edge_feat: object  # (e_pad, De) f32
    # ELL path (stream-engine kernels)
    neigh_idx: object   # (n_pad, k_max) int32
    neigh_coef: object  # (n_pad, k_max) f32; 0 on padding
    neigh_eidx: object  # (n_pad, k_max) int32 into edge_feat
    # node data
    node_feat: object  # (n_pad, Din) f32
    node_mask: object  # (n_pad,) f32; 1 for real nodes
    renumber: object   # (n_pad,) int32 local->global (-1 on padding)
    n_nodes: object    # () int32
    n_edges: object    # () int32

    @property
    def n_pad(self) -> int:
        return self.node_feat.shape[-2]

    @property
    def e_pad(self) -> int:
        return self.src.shape[-1]

    @property
    def k_max(self) -> int:
        return self.neigh_idx.shape[-1]

    def to(self, device) -> "PaddedSnapshot":
        """The same snapshot as torch tensors on ``device``."""
        def conv(a):
            t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
            return t.to(device)

        return PaddedSnapshot(**{f.name: conv(getattr(self, f.name))
                                 for f in dataclasses.fields(self)})


def pad_snapshot(
    ls: LocalSnapshot,
    feat_table: np.ndarray,
    n_pad: int,
    e_pad: int,
    k_max: int,
) -> PaddedSnapshot:
    """Pad a renumbered snapshot into the (n_pad, e_pad, k_max) bucket.

    ``feat_table`` is the global node-feature store (G, Din); the renumber
    table selects the active rows.
    """
    n, e = ls.n_nodes, ls.src.shape[0]
    if n > n_pad or e > e_pad:
        raise ValueError(f"snapshot ({n},{e}) exceeds bucket ({n_pad},{e_pad})")
    de = ls.edge_feat.shape[1]
    src = np.full(e_pad, n_pad - 1, np.int32)
    dst = np.full(e_pad, n_pad - 1, np.int32)
    coef = np.zeros(e_pad, np.float32)
    ef = np.zeros((e_pad, de), np.float32)
    src[:e], dst[:e], coef[:e], ef[:e] = ls.src, ls.dst, ls.coef, ls.edge_feat
    nidx, ncoe, neid = to_ell(ls, n_pad, k_max)
    nf = np.zeros((n_pad, feat_table.shape[1]), np.float32)
    nf[:n] = feat_table[ls.renumber]
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    ren = np.full(n_pad, -1, np.int32)
    ren[:n] = ls.renumber
    return PaddedSnapshot(
        src=src, dst=dst, coef=coef, edge_feat=ef,
        neigh_idx=nidx, neigh_coef=ncoe, neigh_eidx=neid,
        node_feat=nf, node_mask=mask, renumber=ren,
        n_nodes=np.int32(n), n_edges=np.int32(e),
    )


def empty_padded(n_pad: int, e_pad: int, k_max: int, din: int,
                 de: int) -> PaddedSnapshot:
    """An all-padding snapshot of the given bucket and feature dims: a
    no-op on the recurrent state (masks 0, renumber -1 so every scatter
    drops) with all-zero outputs."""
    return PaddedSnapshot(
        src=np.full(e_pad, n_pad - 1, np.int32),
        dst=np.full(e_pad, n_pad - 1, np.int32),
        coef=np.zeros(e_pad, np.float32),
        edge_feat=np.zeros((e_pad, de), np.float32),
        neigh_idx=np.zeros((n_pad, k_max), np.int32),
        neigh_coef=np.zeros((n_pad, k_max), np.float32),
        neigh_eidx=np.zeros((n_pad, k_max), np.int32),
        node_feat=np.zeros((n_pad, din), np.float32),
        node_mask=np.zeros(n_pad, np.float32),
        renumber=np.full(n_pad, -1, np.int32),
        n_nodes=np.int32(0),
        n_edges=np.int32(0),
    )


def stack_streams(snaps: list):
    """Stack padded snapshots or event blocks (same bucket, one type) along
    a new leading axis: T steps of one stream, or B streams."""
    def stack(xs):
        if torch.is_tensor(xs[0]):
            return torch.stack(list(xs), dim=0)
        return np.stack([np.asarray(x) for x in xs], axis=0)

    kind = type(snaps[0])
    return kind(**{f.name: stack([getattr(s, f.name) for s in snaps])
                   for f in dataclasses.fields(kind)})


def stack_ragged(streams: list, device):
    """B streams of unequal T — padded snapshots or event blocks, one type —
    stacked to the longest as (B, T_max, ...) tensors on ``device``; a
    shorter stream's tail repeats its last entry (a ragged launch masks it
    out). Returns (stacked, lengths)."""
    lens = [int(s.node_mask.shape[0]) for s in streams]
    t_max = max(lens)

    def fill(a, t):
        return a if t == t_max else torch.cat(
            [a, a[-1:].expand(t_max - t, *a.shape[1:])])

    kind = type(streams[0])
    on_dev = [s.to(device) for s in streams]
    return (kind(**{
        f.name: torch.stack([fill(getattr(s, f.name), t)
                             for s, t in zip(on_dev, lens)])
        for f in dataclasses.fields(kind)}), lens)
