"""Tenant supervision for the multi-tenant serve engine.

The engine's recovery contract: a per-tenant failure anywhere on the serve
path — malformed snapshot, no-fit bucket, failed or overdue launch,
mid-commit crash — quarantines THAT tenant and the batch continues;
recurrent state is checkpointed before every chunk launch and rolled back
on failure, so a replayed chunk can never double-evolve state.

This module owns the bookkeeping half of that contract:

  * :class:`TenantResult` — one tenant's outcome: served outputs, the
    quarantining error (None = healthy), and the recovery counters
    (retries, rollbacks, degraded launches).
  * :class:`SupervisionPolicy` — the plan-derived recovery knobs
    (``supervision`` / ``max_retries`` / ``retry_backoff_ms`` /
    ``launch_timeout_ms`` / ``degrade``).
  * :class:`TenantSupervisor` — quarantine state and checkpoint / rollback
    of the per-tenant recurrent-state dict.

**Checkpoints hold references, not copies.** Torch tensors can change in
place, so a reference checkpoint is complete only while nothing writes
into a tenant's state tensors, and nothing does:

  * the server stacks the members' states into a fresh (B, ...) batch for
    every launch (``torch.stack`` copies), so a launch never sees a
    tenant's own tensors;
  * every CUDA engine writes its final state into a clone of its input
    (``kernels/engine.py``: ``_gcrn_cuda``, ``_evolve_cuda``,
    ``_stacked_cuda``, ``_tgn_cuda``; the paged engines' page writes and
    EvolveGCN's weight update land in that clone), and the plain versions
    and the force-ref oracles build new tensors;
  * a commit replaces dict entries with copies of the tenant's rows of the
    launch's output; it never writes into the tensors a checkpoint holds.

``tests/test_torch_chaos.py`` pins this: a launch leaves its input states
bit for bit unchanged on the kernel route and the force-ref route, resident
and paged, and the mid-commit rollback replays to the fault-free states.
``chip_smoke.py`` checks on the card that a served run leaves the caller's
state tensors unchanged.

The launch / degrade driver itself lives once in the engine
(``SnapshotServer._run_group_supervised``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# Degradation ladder rungs, slowest recovery last: the batched stream
# launch, a solo (B=1) stream launch per member, the plain PyTorch oracle
# via the kernels/ops force-ref gate. Later rungs are slower but share no
# failure mode with the kernel path.
LADDER = ("batched", "solo", "oracle")


def map_state(fn, state):
    """``fn`` applied to every tensor of a recurrent state: a dict of
    tensors or of lists of tensors (EvolveGCN's per-layer weights)."""
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(map_state(fn, v) for v in state)
    return fn(state)


@dataclass
class TenantResult:
    """One tenant's serve outcome. ``outputs`` is the SAME list object the
    engine returns in its outputs dict, so partial results served before a
    quarantine stay visible. ``error is None`` means healthy."""

    sid: object
    outputs: list = field(default_factory=list)
    error: Optional[BaseException] = None
    failed_site: Optional[str] = None
    retries: int = 0
    rollbacks: int = 0
    degraded_launches: int = 0
    evictions: int = 0   # state pages spilled to host (continuous scheduler)
    recoveries: int = 0  # state pages restored from host

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass(frozen=True)
class SupervisionPolicy:
    """Plan-derived recovery policy."""

    isolate: bool = False          # quarantine per tenant vs raise (strict)
    max_retries: int = 0           # same-group retries before escalating
    backoff_ms: float = 10.0       # exponential backoff base
    timeout_ms: Optional[float] = None  # per-launch deadline (None = off)
    degrade: bool = False          # enable the solo/oracle ladder rungs

    @classmethod
    def from_plan(cls, plan) -> "SupervisionPolicy":
        return cls(isolate=plan.supervision == "isolate",
                   max_retries=plan.max_retries,
                   backoff_ms=plan.retry_backoff_ms,
                   timeout_ms=plan.launch_timeout_ms,
                   degrade=plan.degrade)

    def backoff_s(self, attempt: int) -> float:
        """Exponential backoff before retry ``attempt`` (1-based), in
        seconds."""
        return self.backoff_ms * (2 ** (attempt - 1)) / 1e3


class TenantSupervisor:
    """Quarantine + checkpoint/rollback bookkeeping for one serve run.

    One instance per ``run`` / ``run_multi`` call; the engine consults
    ``alive`` / ``ok`` to stop scheduling a quarantined tenant and folds
    the per-tenant counters into ``ServeStats`` at the end. ``device`` is
    where :meth:`recover_from_host` puts a recovered state.
    """

    def __init__(self, sids, policy: SupervisionPolicy,
                 outputs: Optional[dict] = None, device="cpu"):
        self.policy = policy
        self.device = torch.device(device)
        self.results = {
            sid: TenantResult(sid, outputs=outputs[sid]
                              if outputs is not None else [])
            for sid in sids
        }

    # ------------------------------------------------------- queries ----

    def ok(self, sid) -> bool:
        return self.results[sid].ok

    def alive(self, sids) -> list:
        return [sid for sid in sids if self.results[sid].ok]

    @property
    def quarantined(self) -> dict:
        return {sid: r for sid, r in self.results.items() if not r.ok}

    # -------------------------------------------- checkpoint/rollback ----

    def checkpoint(self, states: dict, sids) -> dict:
        """Snapshot the recurrent state of ``sids`` before a chunk launch:
        the references (the module docstring says why that is a complete
        checkpoint)."""
        return {sid: states[sid] for sid in sids}

    def rollback(self, states: dict, ckpt: dict) -> None:
        """Restore every checkpointed tenant's state (undoing whatever a
        failed commit wrote) and count the rollback per tenant — the retry
        replays the chunk from exactly the pre-launch state, so recurrent
        state (h / c, evolving W) advances at most once per served
        snapshot."""
        for sid, state in ckpt.items():
            states[sid] = state
            self.results[sid].rollbacks += 1

    # -------------------------------------------- eviction / recovery ----

    def evict_to_host(self, states: dict, sid) -> dict:
        """Spill ``sid``'s recurrent state to a host page: take the
        checkpoint, copy it to numpy, and REMOVE the device entry. Returns
        the host page (a state of numpy arrays)."""
        ckpt = self.checkpoint(states, [sid])
        page = map_state(lambda a: a.detach().cpu().numpy(), ckpt[sid])
        del states[sid]
        self.results[sid].evictions += 1
        return page

    def recover_from_host(self, states: dict, sid, page) -> None:
        """Restore an evicted tenant's state from its host page onto the
        supervisor's device (the inverse of :meth:`evict_to_host`; a bit
        for bit round trip)."""
        states[sid] = map_state(
            lambda a: torch.as_tensor(np.asarray(a), device=self.device),
            page)
        self.results[sid].recoveries += 1

    # ------------------------------------------------------ recording ----

    def note_retry(self, sids, attempt: int, sleep: bool = True) -> None:
        """Count a retry for every member and apply exponential backoff."""
        for sid in sids:
            self.results[sid].retries += 1
        if sleep and self.policy.backoff_ms > 0:
            time.sleep(self.policy.backoff_s(attempt))

    def note_degraded(self, sid) -> None:
        self.results[sid].degraded_launches += 1

    def quarantine(self, sid, error: BaseException,
                   site: Optional[str] = None) -> None:
        """Mark ``sid`` failed. Under the strict policy the error is
        re-raised instead (fault isolation is opt-in: plan
        ``supervision="isolate"``)."""
        if not self.policy.isolate:
            raise error
        r = self.results[sid]
        if r.ok:  # first failure wins; later noise keeps the root cause
            r.error = error
            r.failed_site = site if site is not None else getattr(
                error, "site", None)

    # ---------------------------------------------------------- stats ----

    def totals(self) -> dict:
        """Aggregate counters for ServeStats."""
        rs = self.results.values()
        return {
            "retries": sum(r.retries for r in rs),
            "rollbacks": sum(r.rollbacks for r in rs),
            "degraded_launches": sum(r.degraded_launches for r in rs),
            "evictions": sum(r.evictions for r in rs),
            "recoveries": sum(r.recoveries for r in rs),
            "tenant_errors": {sid: r.error for sid, r in self.results.items()
                              if not r.ok},
        }
