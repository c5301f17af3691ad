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

from repro_torch import obs
from repro_torch.graph.csr import LocalSnapshot, to_ell


def round_up(n: int, m: int) -> int:
    """Round ``n`` up to the next multiple of ``m``."""
    return ((n + m - 1) // m) * m


def pow2_target(real: int, cap: int | None = None) -> int:
    """Next power of two >= ``real`` (>= 1), optionally capped: the padded
    chunk lengths and batch sizes of the serve engine's launches.

    The result is always >= ``real``: a ``cap`` below ``real`` would
    truncate live data, so it raises ``ValueError``; a satisfiable cap
    clamps the power of two down to ``cap`` (still >= ``real``)."""
    if cap is not None and cap < real:
        raise ValueError(
            f"pow2_target: cap={cap} < real={real} — a padding target "
            "smaller than the real length would truncate live data")
    target = 1
    while target < real:
        target *= 2
    return max(min(target, cap), 1) if cap is not None else target


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


def empty_like_padded(ps: PaddedSnapshot) -> PaddedSnapshot:
    """An all-padding snapshot in the same bucket as ``ps``."""
    return empty_padded(ps.n_pad, ps.e_pad, ps.k_max, ps.node_feat.shape[1],
                        ps.edge_feat.shape[1])


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
    with obs.span("stack_ragged"):
        device = torch.device(device)
        with obs.sync(device if any(host_copy(s, device) for s in streams)
                      else None, "upload"):
            on_dev = [s.to(device) for s in streams]
        return (kind(**{
            f.name: torch.stack([fill(getattr(s, f.name), t)
                                 for s, t in zip(on_dev, lens)])
            for f in dataclasses.fields(kind)}), lens)


def host_copy(stream, device) -> bool:
    """Does moving a padded stream (or event-block stream) to ``device``
    copy it from host memory: host arrays, or CPU tensors bound for a
    card?"""
    m = stream.node_mask
    return not torch.is_tensor(m) or (m.device.type == "cpu"
                                      and torch.device(device).type != "cpu")


def unpad_snapshot(ps: PaddedSnapshot) -> dict:
    """Strip the padding from a host PaddedSnapshot back to ragged arrays:
    the live COO slice and the per-node arrays (keys src, dst, coef,
    edge_feat, node_feat, renumber); ``pad_snapshot``'s inverse up to the
    ELL conversion."""
    n = int(ps.n_nodes)
    e = int(ps.n_edges)
    return {
        "src": np.asarray(ps.src)[:e],
        "dst": np.asarray(ps.dst)[:e],
        "coef": np.asarray(ps.coef)[:e],
        "edge_feat": np.asarray(ps.edge_feat)[:e],
        "node_feat": np.asarray(ps.node_feat)[:n],
        "renumber": np.asarray(ps.renumber)[:n],
    }


# ------------------------------------------------------------ buckets ----
# Host-side numpy code: the serve engine's producer threads call it, so
# nothing here touches a device.

def choose_bucket(n: int, e: int, k: int,
                  buckets: tuple[tuple[int, int, int], ...]) -> tuple[int, int, int]:
    """The smallest (n_pad, e_pad, k_max) bucket that fits a snapshot of n
    nodes, e edges and in-degree k."""
    for b in buckets:
        if n <= b[0] and e <= b[1] and k <= b[2]:
            return b
    raise ValueError(f"no bucket fits snapshot ({n},{e},k={k})")


def choose_bucket_batch(dims: "list[tuple[int, int, int]]",
                        buckets: tuple[tuple[int, int, int], ...]
                        ) -> tuple[int, int, int]:
    """The smallest bucket covering EVERY (n, e, k) in ``dims``: one shape
    for a chunk of snapshots, so it can batch with same-bucket chunks of
    other streams (the chunk pays the max of its members)."""
    if not dims:
        raise ValueError("empty chunk: no dims to bucket")
    n = max(d[0] for d in dims)
    e = max(d[1] for d in dims)
    k = max(d[2] for d in dims)
    return choose_bucket(n, e, k, buckets)


def bucket_cost(bucket: tuple[int, int, int]) -> int:
    """Padded per-snapshot compute proxy of a bucket: ELL aggregation lanes
    (n_pad * k_max) plus the per-node transform rows (n_pad)."""
    n_pad, _, k_max = bucket
    return n_pad * (k_max + 1)


def promote_bucket_groups(groups: dict, buckets: tuple,
                          max_overhead: float, cost=bucket_cost) -> dict:
    """Cross-bucket batching by bucket promotion.

    ``groups`` maps bucket -> [(sid, chunk, bucket), ...] queued for one
    batched launch each. A smaller-bucket group joins the next-larger
    occupied bucket when cost(target) <= max_overhead * cost(own) holds for
    every member's ORIGINAL bucket; promotion chains up the buckets while
    every hop honours that guard. Returns a new groups dict with the
    members re-tagged to their target bucket. ``cost`` is the static proxy
    ``bucket_cost`` or the serve engine's measured per-bucket step times.
    """
    order = {b: i for i, b in enumerate(buckets)}
    merged: dict = {b: list(members) for b, members in groups.items()}
    # ascending visit order: merges only move members into LATER buckets,
    # so every visited key is still present
    for b in sorted(merged, key=order.get):
        bigger = [b2 for b2 in merged if b2 != b and order[b2] > order[b]]
        if not bigger:
            continue
        target = min(bigger, key=order.get)
        if any(cost(target) > max_overhead * cost(own)
               for _, _, own in merged[b]):
            continue
        merged[target] = merged[target] + merged[b]
        del merged[b]
    return {b: [(sid, chunk, b) for sid, chunk, _ in members]
            for b, members in merged.items()}


DEFAULT_BUCKETS = ((128, 512, 32), (320, 1024, 48), (640, 4096, 96))
