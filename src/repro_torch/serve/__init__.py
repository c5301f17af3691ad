"""Serving: the DGNN snapshot server (``SnapshotServer``: buckets and
promotion, the round scheduler, the express lane, supervision and fault
injection), its continuous-batching scheduler (``ContinuousScheduler``)
with the paged tenant-state pool (``TenantStatePool``, ``PoolOverflow``),
and the LM scaffold's greedy decode (``lm_serve``).

``__all__`` is the JAX package's ``repro.serve.__all__``. ``SUPERVISED``
(the exception classes a supervised step catches, serve/faults.py) is the
port's own and is importable from here without being part of it.
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
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.state_pool import PoolOverflow, TenantStatePool
from repro_torch.serve.supervision import (
    SupervisionPolicy,
    TenantResult,
    TenantSupervisor,
)

__all__ = [
    "ContinuousScheduler",
    "FAULT_SCOPES",
    "FAULT_SITES",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "LaunchTimeout",
    "PoolOverflow",
    "ServeFault",
    "ServeStats",
    "SnapshotServer",
    "SnapshotValidationError",
    "SupervisionPolicy",
    "TenantResult",
    "TenantStatePool",
    "TenantSupervisor",
    "generate",
    "make_serve_step",
    "validate_snapshot",
]
