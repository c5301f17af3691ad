"""Deterministic fault injection and the typed serve-boundary errors.

The serve engine's fault-isolation contract is only trustworthy if every
fault site can be driven on demand, so the chaos tests pin it. This module
provides:

  * :class:`FaultPlan` / :class:`FaultSpec` — a seeded, site-addressable
    description of which serve-path operations fail, carried by the typed
    ``repro_torch.api.StreamPlan`` (``fault_plan=``). Sites mirror the
    engine's failure surface:

      ``preprocess``  host-side snapshot preprocessing (producer thread)
      ``bucket``      bucket selection (no-fit / mis-sized snapshots)
      ``launch``      the stream-engine launch itself (fired on the host
                      by the ``kernels/ops`` fault hook, once per launch,
                      just before it: the real dispatch layer, not a
                      serve-side mock)
      ``evolve``      the post-launch state-commit phase (the site whose
                      recovery must prove rollback: a replayed chunk may
                      never double-evolve recurrent state)

  * :class:`FaultInjector` — the mutable runtime counterpart: counts
    matching probes per spec and raises :class:`InjectedFault` (or sleeps,
    for deadline tests) when a spec's occurrence window is hit. The same
    probe sequence fires the same faults: determinism comes from
    occurrence counting, not wall clocks; ``seed`` lets a chaos harness
    derive reproducible random placements before building the plan.

  * typed serve-boundary errors: :class:`SnapshotValidationError` (and
    :func:`validate_snapshot`, the serve-boundary input gate) and
    :class:`LaunchTimeout` (deadline exceeded on a stream launch).

  * :data:`SUPERVISED` — the exception classes the serve engine's
    supervised runner, its calibration fallback and its consumer loops
    treat as a tenant's fault (retry, roll back, degrade, quarantine).
    The JAX package catches ``Exception`` there; this package names the
    classes a serve path can raise (the analyzer's broad-except rule
    covers this package's files). Anything else — a programming error —
    propagates out of ``run`` / ``run_multi`` after the producer threads
    are shut down.

Nothing here imports the engine — the engine imports this, so the fault
machinery stays usable from tests without a server.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

FAULT_SITES = ("preprocess", "bucket", "launch", "evolve")
FAULT_SCOPES = ("any", "batched", "kernel")


class ServeFault(RuntimeError):
    """Base of the serve engine's typed fault exceptions. ``tenant`` is
    the addressed tenant id (None = unattributable) — the supervisor uses
    it to quarantine the failed member instead of the whole batch."""

    def __init__(self, message: str, *, tenant=None, site: Optional[str] = None):
        super().__init__(message)
        self.tenant = tenant
        self.site = site


class InjectedFault(ServeFault):
    """A fault fired by a :class:`FaultInjector` (chaos testing only)."""


class LaunchTimeout(ServeFault):
    """A stream-engine launch exceeded the plan's ``launch_timeout_ms``.

    A launch cannot be cancelled mid-flight, so the deadline is enforced
    on completion (the device synchronized): the overdue result is
    DISCARDED (never committed to tenant state) and the launch is treated
    as failed — retried, degraded, or quarantined per the plan's recovery
    policy.
    """


class SnapshotValidationError(ServeFault, ValueError):
    """A snapshot rejected at the serve boundary (malformed input), with
    the offending tenant attached so supervision can quarantine it."""


#: what the supervised runner, the calibration fallback and the consumer
#: loops treat as a tenant's fault: the typed serve faults, and what a
#: launch or a snapshot can raise — torch's CUDA errors and
#: ``torch.cuda.OutOfMemoryError`` are RuntimeErrors, the kernel wrappers'
#: refusals ValueErrors, a malformed input an index, key or arithmetic
#: error, a kernel library that does not load an OSError. Narrower than
#: the JAX package's ``except Exception``: anything else (a TypeError or
#: AttributeError of a programming fault, an AssertionError) propagates
#: after a clean shutdown. Of these only a ``ServeFault`` may open the
#: degradation ladder's oracle rung (serve/engine.py): a kernel that fails
#: to build, load or launch is never served by the plain path.
SUPERVISED = (ServeFault, RuntimeError, ValueError, IndexError, KeyError,
              ArithmeticError, OSError)


def validate_snapshot(snap, n_global: int, tenant=None) -> None:
    """Serve-boundary input gate: reject malformed COO snapshots BEFORE
    they reach ``renumber_and_normalize`` / ``to_ell`` / the kernel, where
    negative or out-of-range ids would silently drop or gather garbage.
    Raises :class:`SnapshotValidationError` carrying the tenant.

    Checks: src/dst shape agreement, negative node ids, ids >= n_global
    (the global feature-table / state-store row count), non-finite edge
    features.
    """
    src = np.asarray(snap.src)
    dst = np.asarray(snap.dst)
    ef = np.asarray(snap.edge_feat)

    def bad(reason):
        who = "" if tenant is None else f"tenant {tenant!r}: "
        raise SnapshotValidationError(
            f"{who}snapshot t={getattr(snap, 't_index', '?')} rejected: "
            f"{reason}", tenant=tenant, site="preprocess")

    if src.shape != dst.shape or src.ndim != 1:
        bad(f"src/dst shape mismatch {src.shape} vs {dst.shape}")
    if ef.shape[0] != src.shape[0]:
        bad(f"edge_feat has {ef.shape[0]} rows for {src.shape[0]} edges")
    if src.size:
        lo = int(min(src.min(), dst.min()))
        hi = int(max(src.max(), dst.max()))
        if lo < 0:
            bad(f"negative node id {lo}")
        if hi >= n_global:
            bad(f"node id {hi} out of range (n_global={n_global})")
    if ef.size and not np.isfinite(ef).all():
        bad("non-finite edge features")


@dataclass(frozen=True)
class FaultSpec:
    """One addressable fault: fires at ``site`` on the ``index``-th
    matching probe (per-spec occurrence counter) and for ``count``
    consecutive matching probes after it — so a transient fault
    (``count=1``) is survived by one retry while a persistent one
    (``count`` large) exhausts retries and exercises quarantine or the
    degradation ladder.

    ``tenant`` addresses the fault (None = untargeted: matches any probe
    and is unattributable, so the supervisor cannot quarantine a single
    member for it). ``scope`` narrows launch-site probes: ``"batched"``
    fires only on launches carrying more than one live tenant (the ladder
    then recovers via solo launches), ``"kernel"`` only on non-force-ref
    launches (the ladder then recovers via the plain PyTorch oracle
    rung).
    ``delay_ms > 0`` sleeps instead of raising — the deadline-test knob
    for ``launch_timeout_ms``.
    """

    site: str
    tenant: Optional[str] = None
    index: int = 0
    count: int = 1
    scope: str = "any"
    delay_ms: float = 0.0
    message: str = "injected fault"

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {FAULT_SITES}")
        if self.scope not in FAULT_SCOPES:
            raise ValueError(f"unknown fault scope {self.scope!r}; "
                             f"scopes: {FAULT_SCOPES}")
        if self.scope != "any" and self.site != "launch":
            raise ValueError(f"scope {self.scope!r} only narrows 'launch' "
                             f"probes; site is {self.site!r}")
        if not (isinstance(self.index, int) and self.index >= 0):
            raise ValueError(f"index={self.index!r}: need an int >= 0")
        if not (isinstance(self.count, int) and self.count >= 1):
            raise ValueError(f"count={self.count!r}: need an int >= 1")
        if not self.delay_ms >= 0:
            raise ValueError(f"delay_ms={self.delay_ms!r}: need >= 0")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic chaos schedule: a tuple of :class:`FaultSpec` plus
    the seed the placements were drawn from (recorded so a failing chaos
    run is reproducible from its plan alone). Frozen like the StreamPlan
    that carries it; build the runtime counter state with
    :meth:`injector`."""

    specs: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise ValueError(f"FaultPlan.specs needs FaultSpecs; got "
                                 f"{s!r}")
        if not isinstance(self.seed, int):
            raise ValueError(f"seed={self.seed!r}: need an int")

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    def sites(self) -> frozenset:
        return frozenset(s.site for s in self.specs)


@dataclass
class FaultInjector:
    """Runtime occurrence counters for one :class:`FaultPlan`.

    ``probe(site, ...)`` is called by the serve engine at each fault site;
    every spec that matches the probe's (site, tenants, scope) coordinates
    advances its own counter, and a counter inside ``[index, index+count)``
    fires the fault. The last fired fault is stashed so the supervisor can
    attribute a launch failure to its root fault via :meth:`take_fired`.
    """

    plan: FaultPlan
    _counts: list = field(default_factory=list)
    _fired: Optional[InjectedFault] = None

    def __post_init__(self):
        import threading

        self._counts = [0] * len(self.plan.specs)
        # probes arrive from concurrent producer threads AND the device
        # loop; occurrence counting must not race
        self._lock = threading.Lock()

    def rng(self) -> np.random.Generator:
        """Seeded generator for random (but reproducible) placements."""
        return np.random.default_rng(self.plan.seed)

    def _matches(self, spec: FaultSpec, site, tenants, n_live, force_ref):
        if spec.site != site:
            return False
        if spec.tenant is not None and spec.tenant not in tenants:
            return False
        if spec.scope == "batched" and not (n_live is not None and n_live > 1):
            return False
        if spec.scope == "kernel" and force_ref:
            return False
        return True

    def probe(self, site: str, tenants=(), n_live=None, force_ref=False):
        """Advance every matching spec's counter; fire the first spec whose
        occurrence window is hit. Delay specs sleep (deadline injection)
        instead of raising; at most one fault is raised per probe."""
        import time

        to_raise = None
        delay_s = 0.0
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if not self._matches(spec, site, tenants, n_live, force_ref):
                    continue
                n = self._counts[i]
                self._counts[i] += 1
                if not (spec.index <= n < spec.index + spec.count):
                    continue
                if spec.delay_ms > 0:
                    delay_s += spec.delay_ms / 1e3
                    continue
                if to_raise is None:
                    to_raise = InjectedFault(
                        f"{spec.message} (site={site}, "
                        f"tenant={spec.tenant!r}, occurrence {n})",
                        tenant=spec.tenant, site=site)
            if to_raise is not None:
                self._fired = to_raise
        if delay_s > 0:
            time.sleep(delay_s)  # deadline injection (outside the lock)
        if to_raise is not None:
            raise to_raise

    def take_fired(self) -> Optional[InjectedFault]:
        """Pop the last fault this injector raised (the supervisor's
        attribution of a failed launch to its root fault)."""
        fired, self._fired = self._fired, None
        return fired
