"""Paged pool of per-tenant recurrent state for the continuous scheduler.

The multi-tenant serve engine keeps one recurrent-state store per tenant
(h / c node states, or EvolveGCN's evolving weight matrices). With many
tenants those stores cannot all stay on the card: the pool bounds how many
do (``plan.state_pool_pages`` pages, one tenant's full state a page, the
granularity at which a stream launch loads state), spills the
least-recently-scheduled tenants to host memory, and restores a spilled
tenant the next time the scheduler composes it into a launch.

**What a device page is on the H100.** Between launches every tenant's
state is a set of fp32 tensors in the card's HBM (global memory), whichever
``state_residency`` the plan picks; a device page is one tenant's set of
them, each with storage of its own (``SnapshotServer._commit_group`` copies
a tenant's rows out of its launch's batch, so evicting a tenant frees its
bytes). The residency decides only where the stream engine keeps the store
INSIDE a launch: in the shared memory of the stream's cluster of CTAs
(``"vmem"``), or in global memory behind the TMA ring (``"hbm_paged"``).
The capacity rule is the JAX package's all the same (``HBM_PAGE_FACTOR``
below), so a plan evicts and recovers exactly as often on both.

Eviction reuses the supervision checkpoint machinery
(``TenantSupervisor.evict_to_host`` / ``recover_from_host``): a spill is the
reference checkpoint a chunk launch takes, copied to numpy; recovery copies
it back onto the server's device. fp32 state round-trips the host copy bit
for bit, so a tenant that was evicted and recovered mid-stream serves
outputs identical to one that stayed on the card. Both copies synchronize
with the card, and both run on the device loop's thread.

The pool owns the BLOCK TABLE: ``sid -> "device" | "host"``. The device
side is the engine's ordinary ``states`` dict (``_stage_group`` still reads
``states[sid]``); the host side is ``self.host_pages``. ``acquire`` is the
only way states move, so a checkpoint taken for an in-flight launch can
never be evicted under it: the scheduler acquires the tick's working set
BEFORE the supervised launch, and eviction only ever picks tenants OUTSIDE
the set being acquired.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.serve.supervision import TenantSupervisor

# capacity multiplier for HBM-paged tenants: with
# ``plan.state_residency="hbm_paged"`` the stream engine keeps each tenant's
# store in global memory inside a launch too (only a ring of TMA boxes
# transits shared memory), so the pool lifts its effective capacity by this
# factor rather than asking every caller to re-derive a page budget (the
# JAX package's rule, kept so both packages page a plan alike)
HBM_PAGE_FACTOR = 8


class PoolOverflow(RuntimeError):
    """A working set larger than the pool was requested."""


class TenantStatePool:
    """Fixed-capacity paging of the per-tenant recurrent-state dict.

    ``states`` is the engine's state dict (mutated in place); ``pages=None``
    disables eviction (every tenant stays on the card, and the pool is
    bookkeeping only). ``residency`` is the plan's ``state_residency``:
    under ``"hbm_paged"`` the effective capacity is ``pages *
    HBM_PAGE_FACTOR`` (``capacity``); the nominal ``pages`` is kept for
    reporting.
    """

    def __init__(self, states: dict, pages: int | None,
                 supervisor: TenantSupervisor, residency: str = "vmem"):
        if pages is not None and pages < 1:
            raise ValueError(f"pages={pages!r}: need >= 1 or None")
        self.states = states
        self.pages = pages
        self.residency = residency
        self.capacity = (None if pages is None
                         else pages * HBM_PAGE_FACTOR
                         if residency == "hbm_paged" else pages)
        self.sup = supervisor
        self.host_pages: dict = {}
        # LRU order over RESIDENT tenants (oldest first)
        self._lru: OrderedDict = OrderedDict(
            (sid, None) for sid in sorted(states, key=repr))
        if self.capacity is not None and len(states) > self.capacity:
            # over-committed from the start: spill down to capacity before
            # the first tick (arbitrary-but-deterministic victim order)
            for sid in list(self._lru):
                if len(self._lru) <= self.capacity:
                    break
                self._evict(sid)

    # ---------------------------------------------------------- queries ----

    @property
    def resident(self) -> set:
        return set(self._lru)

    def location(self, sid) -> str:
        """Block-table lookup: 'device' or 'host'."""
        if sid in self._lru:
            return "device"
        if sid in self.host_pages:
            return "host"
        raise KeyError(f"tenant {sid!r} is not in the pool")

    # ---------------------------------------------------------- paging ----

    def _evict(self, sid) -> None:
        self.host_pages[sid] = self.sup.evict_to_host(self.states, sid)
        del self._lru[sid]

    def _recover(self, sid) -> None:
        self.sup.recover_from_host(self.states, sid, self.host_pages[sid])
        del self.host_pages[sid]
        self._lru[sid] = None

    def acquire(self, sids) -> None:
        """Make every tenant in ``sids`` device-resident (recovering host
        pages), evicting least-recently-scheduled tenants OUTSIDE the set
        as needed, and mark the set most-recently used. Raises
        :class:`PoolOverflow` if the set alone exceeds the pool: the
        scheduler bounds its tick working set to the pool size, so hitting
        this means a scheduler bug, not load."""
        working = list(dict.fromkeys(sids))
        if self.capacity is not None and len(working) > self.capacity:
            raise PoolOverflow(
                f"working set of {len(working)} tenants exceeds the "
                f"{self.capacity}-page state pool")
        for sid in working:
            if sid not in self._lru:
                if self.capacity is not None:
                    keep = set(working)
                    while len(self._lru) >= self.capacity:
                        victim = next(s for s in self._lru if s not in keep)
                        self._evict(victim)
                self._recover(sid)
        for sid in working:  # MRU update
            self._lru.move_to_end(sid)

    def flush(self) -> None:
        """Restore every host page to the state dict (end of the serve run:
        the engine returns the full ``states`` dict, wherever each tenant's
        pages lived mid-run). Recovery counters move with it, so forced
        end-of-run restores stay visible in the stats."""
        for sid in list(self.host_pages):
            self._recover(sid)
