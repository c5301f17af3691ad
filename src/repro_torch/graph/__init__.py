from repro_torch.graph.coo import COOSnapshot, TemporalGraph, slice_snapshots, snapshot_stats
from repro_torch.graph.csr import LocalSnapshot, max_in_degree, renumber_and_normalize, to_ell
from repro_torch.graph.events import PaddedEventBlock, pad_event_block, unpad_event_block
from repro_torch.graph.padding import (
    DEFAULT_BUCKETS,
    PaddedSnapshot,
    bucket_cost,
    choose_bucket,
    choose_bucket_batch,
    empty_like_padded,
    empty_padded,
    pad_snapshot,
    pow2_target,
    promote_bucket_groups,
    round_up,
    stack_ragged,
    stack_streams,
    unpad_snapshot,
)
from repro_torch.graph.synthetic import generate_temporal_graph

__all__ = [
    "COOSnapshot", "TemporalGraph", "slice_snapshots", "snapshot_stats",
    "LocalSnapshot", "renumber_and_normalize", "to_ell", "max_in_degree",
    "PaddedEventBlock", "pad_event_block", "unpad_event_block",
    "PaddedSnapshot", "pad_snapshot", "stack_streams", "stack_ragged",
    "choose_bucket", "choose_bucket_batch", "unpad_snapshot",
    "empty_like_padded", "empty_padded", "bucket_cost",
    "promote_bucket_groups", "pow2_target", "round_up",
    "DEFAULT_BUCKETS", "generate_temporal_graph",
]
