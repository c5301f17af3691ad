"""The DGNN models (GCRN-M2, EvolveGCN-O, the stacked GCN -> GRU, TGN,
the static GCN) and the plan executors of the port."""
from repro_torch.core.dataflow import (
    build_model,
    init_states_batched,
    run_batched,
    run_plan,
    run_plan_batched,
    run_stream,
    stack_time,
)
from repro_torch.core.evolvegcn import EvolveGCN
from repro_torch.core.gcrn import GCRN
from repro_torch.core.stacked import StackedDGNN

__all__ = [
    "build_model", "run_plan", "run_plan_batched", "run_stream",
    "run_batched", "init_states_batched", "stack_time",
    "EvolveGCN", "GCRN", "StackedDGNN",
]
