"""Serving: the DGNN snapshot server (``SnapshotServer``: buckets and
promotion, the round scheduler, the express lane, supervision and fault
injection) and the LM scaffold's greedy decode (``lm_serve``).

The JAX package's continuous scheduler (``ContinuousScheduler``) and its
paged tenant-state pool (``TenantStatePool``, ``PoolOverflow``) wait for the
next slice (ROADMAP queue 1, the continuous scheduler); a plan asking for
them raises ``NotImplementedError`` when served.
"""
from repro_torch.serve.engine import ServeStats, SnapshotServer
from repro_torch.serve.faults import (
    FAULT_SCOPES,
    FAULT_SITES,
    SUPERVISED,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    LaunchTimeout,
    ServeFault,
    SnapshotValidationError,
    validate_snapshot,
)
from repro_torch.serve.lm_serve import generate, make_serve_step
from repro_torch.serve.supervision import (
    SupervisionPolicy,
    TenantResult,
    TenantSupervisor,
)

__all__ = [
    "FAULT_SCOPES",
    "FAULT_SITES",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "LaunchTimeout",
    "SUPERVISED",
    "ServeFault",
    "ServeStats",
    "SnapshotServer",
    "SnapshotValidationError",
    "SupervisionPolicy",
    "TenantResult",
    "TenantSupervisor",
    "generate",
    "make_serve_step",
    "validate_snapshot",
]
