"""DGNN model + dataset configs (the paper's own models).

EvolveGCN-O (DGNN-Booster V1 base model): GCN spatial encoder whose weights
are evolved by a GRU. GCRN-M2 (DGNN-Booster V2 base model): graph-conv LSTM.
Dataset stats mirror Table III of the paper (BC-Alpha, UCI).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DGNNConfig:
    name: str
    # "stacked" | "integrated" | "weights_evolved" (dense snapshot
    # streams) | "static" (T=1, no recurrence) | "event_memory" (ragged
    # timestamped event streams) — api.family_for maps each onto its
    # stream-engine registry family, whose cell spec declares the
    # matching temporal contract.
    dgnn_type: str
    gnn: str               # "gcn"
    rnn: str               # "gru" | "lstm" | "none"
    dataflow: str          # preferred engine: "v1" | "v2" | "v3"
    in_dim: int = 64       # raw node-feature dim
    hidden: int = 128      # GNN/RNN hidden width
    n_gnn_layers: int = 2
    edge_dim: int = 8      # edge-embedding dim (0 = no edge features)
    out_dim: int = 64      # task head output (link-pred embedding dim)
    # static padding buckets (TPU needs static shapes; see graph/padding.py)
    max_nodes: int = 640   # >= Table III max nodes (578)
    max_edges: int = 2048  # >= Table III max edges (1686)
    n_streams: int = 1     # batched independent dynamic-graph streams
    # V3 stream-engine D-axis block size: column width of the recurrent
    # state windows when the (n_global, hidden) store exceeds VMEM (see
    # docs/stream_engine.md). None = one block, fully resident.
    stream_td: int | None = None


EVOLVEGCN = DGNNConfig(
    name="evolvegcn",
    dgnn_type="weights_evolved",
    gnn="gcn",
    rnn="gru",
    dataflow="v1",
)

GCRN_M2 = DGNNConfig(
    name="gcrn-m2",
    dgnn_type="integrated",
    gnn="gcn",
    rnn="lstm",
    dataflow="v2",
)

# third taxonomy row of Table I (GCRN-M1 / WD-GCN style); both V1 and V2
# apply — included so the framework covers the whole taxonomy.
STACKED = DGNNConfig(
    name="stacked-gcn-gru",
    dgnn_type="stacked",
    gnn="gcn",
    rnn="gru",
    dataflow="v1",
)

# degenerate static family (GenGNN-style, no recurrence): T=1 snapshots
# fold onto the engine's batch axis — the serve express lane's workload.
STATIC_GCN = DGNNConfig(
    name="static-gcn",
    dgnn_type="static",
    gnn="gcn",
    rnn="none",
    dataflow="v3",
)

# event-driven temporal GNN (TGN/TGAT lineage): timestamped event
# batches over a global node-memory store. NOT in DGNN_CONFIGS — the
# snapshot-stream harness has no timestamps; tests build event streams
# through graph/events.py (tests/test_temporal.py).
TGN = DGNNConfig(
    name="tgn",
    dgnn_type="event_memory",
    gnn="tgn",
    rnn="gru",
    dataflow="v3",
    edge_dim=0,
)


@dataclass(frozen=True)
class DatasetConfig:
    """Synthetic temporal-graph generator parameters matching Table III."""

    name: str
    avg_nodes: int
    avg_edges: int
    max_nodes: int
    max_edges: int
    snapshots: int
    seed: int = 0


BC_ALPHA = DatasetConfig("bc-alpha", 107, 232, 578, 1686, 137, seed=1)
UCI = DatasetConfig("uci", 118, 269, 501, 1534, 192, seed=2)

DGNN_CONFIGS = {c.name: c for c in (EVOLVEGCN, GCRN_M2, STACKED, STATIC_GCN)}
DATASETS = {d.name: d for d in (BC_ALPHA, UCI)}
