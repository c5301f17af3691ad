from repro_torch.graph.coo import COOSnapshot, TemporalGraph, slice_snapshots, snapshot_stats
from repro_torch.graph.csr import LocalSnapshot, max_in_degree, renumber_and_normalize, to_ell
from repro_torch.graph.events import PaddedEventBlock, pad_event_block, unpad_event_block
from repro_torch.graph.padding import (
    PaddedSnapshot,
    empty_padded,
    pad_snapshot,
    round_up,
    stack_ragged,
    stack_streams,
)
from repro_torch.graph.synthetic import generate_temporal_graph

__all__ = [
    "COOSnapshot", "TemporalGraph", "slice_snapshots", "snapshot_stats",
    "LocalSnapshot", "renumber_and_normalize", "to_ell", "max_in_degree",
    "PaddedSnapshot", "pad_snapshot", "stack_streams", "stack_ragged",
    "empty_padded", "PaddedEventBlock", "pad_event_block", "unpad_event_block",
    "round_up", "generate_temporal_graph",
]
