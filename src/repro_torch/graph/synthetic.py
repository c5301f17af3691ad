"""Synthetic temporal-graph generators matching the paper's dataset stats.

BC-Alpha and UCI (Table III) are small temporal interaction networks. The
container has no network access, so we generate statistically matched
synthetic stand-ins: preferential-attachment node reuse (heavy-tailed
degree, like trust/message networks), per-snapshot node/edge counts drawn
to match the reported avg/max.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.dgnn import DatasetConfig
from repro_torch.graph.coo import TemporalGraph


def generate_temporal_graph(ds: DatasetConfig, feat_dim: int = 64) -> tuple[TemporalGraph, np.ndarray]:
    """Returns (temporal graph with time splitter == 1.0, node feature table)."""
    rng = np.random.default_rng(ds.seed)
    # global node pool sized so per-snapshot active counts match avg_nodes
    n_global = ds.max_nodes * 6
    src_all, dst_all, t_all = [], [], []
    # preferential attachment weights, updated as edges arrive
    pop = np.ones(n_global, np.float64)
    for t in range(ds.snapshots):
        # heavy-tailed edge count per snapshot, clipped to max
        e = int(np.clip(rng.lognormal(np.log(ds.avg_edges), 0.45), 8, ds.max_edges))
        # a working set of candidate nodes for this snapshot
        ws = int(np.clip(rng.lognormal(np.log(ds.avg_nodes), 0.35), 8, ds.max_nodes))
        p = pop / pop.sum()
        cand = rng.choice(n_global, size=ws, replace=False, p=p)
        s = rng.choice(cand, size=e)
        d = rng.choice(cand, size=e)
        keep = s != d
        s, d = s[keep], d[keep]
        src_all.append(s)
        dst_all.append(d)
        t_all.append(np.full(s.size, t + 0.5))
        np.add.at(pop, s, 1.0)
        np.add.at(pop, d, 1.0)
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    time = np.concatenate(t_all)
    # edge features: interaction weight + recency channels (like trust scores)
    de = 8
    ef = rng.normal(0, 1, (src.size, de)).astype(np.float32)
    feat_table = rng.normal(0, 1, (n_global, feat_dim)).astype(np.float32)
    return TemporalGraph(src=src, dst=dst, time=time, edge_feat=ef,
                         n_global_nodes=n_global), feat_table
