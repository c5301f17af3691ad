"""Temporal COO edge store + time-splitter snapshot slicing.

This is host-side work ("CPU tasks" in the paper's §IV-D task-scheduling
scheme): the raw dynamic graph arrives as a time-stamped COO edge list, the
host slices it into discrete snapshots G^1..G^T by a time splitter and
computes per-snapshot node/edge counts — exactly the preprocessing the
paper assigns to the host CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TemporalGraph:
    """Raw dynamic graph: time-ordered COO edges over a global node space."""

    src: np.ndarray          # (E,) int64 global node ids
    dst: np.ndarray          # (E,) int64
    time: np.ndarray         # (E,) float64, nondecreasing not required
    edge_feat: np.ndarray    # (E, De) float32 (De may be 0)
    n_global_nodes: int

    def __post_init__(self) -> None:
        assert self.src.shape == self.dst.shape == self.time.shape
        assert self.edge_feat.shape[0] == self.src.shape[0]

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


@dataclass
class COOSnapshot:
    """One discrete-time snapshot, still in global node ids (pre-renumber)."""

    src: np.ndarray          # (e,) int64
    dst: np.ndarray          # (e,) int64
    edge_feat: np.ndarray    # (e, De)
    t_index: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def active_nodes(self) -> np.ndarray:
        return np.unique(np.concatenate([self.src, self.dst]))


def slice_snapshots(tg: TemporalGraph, time_splitter: float) -> list[COOSnapshot]:
    """Slice by fixed time window (the paper's "time splitter").

    Snapshots are contiguous windows of width ``time_splitter`` from
    min(time); empty windows are dropped (matching how dataset snapshot
    counts are reported in Table III).
    """
    order = np.argsort(tg.time, kind="stable")
    src, dst, t = tg.src[order], tg.dst[order], tg.time[order]
    ef = tg.edge_feat[order]
    t0 = float(t[0]) if t.size else 0.0
    bins = np.floor((t - t0) / time_splitter).astype(np.int64)
    out: list[COOSnapshot] = []
    for i, b in enumerate(np.unique(bins)):
        m = bins == b
        out.append(COOSnapshot(src=src[m], dst=dst[m], edge_feat=ef[m], t_index=i))
    return out


def snapshot_stats(snaps: list[COOSnapshot]) -> dict:
    """avg/max node & edge counts, as reported in the paper's Table III."""
    nodes = np.array([s.active_nodes().size for s in snaps])
    edges = np.array([s.n_edges for s in snaps])
    return {
        "avg_nodes": float(nodes.mean()),
        "avg_edges": float(edges.mean()),
        "max_nodes": int(nodes.max()),
        "max_edges": int(edges.max()),
        "snapshots": len(snaps),
    }
