"""Continuous-batching device loop for the multi-tenant serve engine.

The round-based ``run_multi`` loop has a BARRIER between rounds: every
active tenant must deliver its next chunk (or end of stream) before any
launch happens, so one tenant with a long snapshot backlog (a client
replaying history, a reconnect after downtime) stalls every incremental
tenant behind its whole prefill, and a tenant whose producer is slow
stalls the round outright.

This module replaces the barrier with ITERATION-LEVEL scheduling (the
vLLM / sglang continuous-batching idea, at snapshot-stream granularity):

  tick loop    Each tick composes a fresh ragged batch from whatever
               snapshots are READY, without waiting for stragglers; a
               tenant joins a launch with a 1-snapshot chunk if that is all
               it has. On the card a stream runs on one cluster of CTAs and
               its state crosses launches in fp32, so serving a stream in
               chunks of any lengths, beside any co-tenants, is bit for bit
               the same as any other chunking in a fixed bucket: tick
               composition is a scheduling decision, not a numerical one.

  chunked      A backlogged tenant (more than ``stream_chunk`` snapshots
  prefill      queued) is served at most ``plan.prefill_chunk`` snapshots
               a tick instead of a full chunk, so its backlog drains
               INTERLEAVED with the other tenants' incremental steps.

  paged state  Per-tenant recurrent state lives in a fixed-size paged pool
  pool         (``plan.state_pool_pages`` device-resident tenants,
               serve/state_pool.TenantStatePool). The tick's working set is
               capped at the pool size; least-recently-scheduled tenants
               outside it are spilled to the host and recovered onto the
               server's device when next scheduled.

  fairness     Ready tenants are served least-recently-scheduled first, so
               under pool pressure the working set round-robins instead of
               starving whoever sorts last.

Everything below the tick (bucketing, promotion, the supervised
stage / commit launch with checkpoint and rollback, retries, quarantine,
the degradation ladder) is the same engine code the round loop runs
(``SnapshotServer._run_group_supervised`` and the rest), so the fault
contract holds unchanged under this scheduler. Every torch call (the
launches, eviction's copy to the host, recovery's copy back) runs on the
device loop's thread; producer threads do numpy work only.
"""
from __future__ import annotations

import queue
import time
from collections import deque

from repro_torch.graph.padding import promote_bucket_groups
from repro_torch.serve.engine import _producer_error
from repro_torch.serve.faults import SUPERVISED
from repro_torch.serve.state_pool import TenantStatePool
from repro_torch.serve.supervision import TenantSupervisor

# idle backoff while every backlog is empty but producers are still
# running (host preparation slower than the device loop)
_IDLE_SLEEP_S = 5e-4


class ContinuousScheduler:
    """One continuous-batching serve run over a ``SnapshotServer``.

    Stateless between runs: ``SnapshotServer.run_multi`` builds one per
    call when ``plan.scheduler == "continuous"``.
    """

    def __init__(self, server):
        self.srv = server

    # ---------------------------------------------------------- admission ----

    def _admit(self, qs, backlog, eof, active, sup: TenantSupervisor) -> None:
        """Drain every active producer queue without blocking into the
        per-tenant backlogs. End of stream marks the tenant draining; a
        producer's tenant fault (validation, no-fit bucket, injected fault)
        quarantines the tenant per policy and discards its backlog; any
        other producer error is raised. Items from already-quarantined
        tenants are never admitted."""
        for sid in sorted(active):
            if sid in eof:
                continue
            while True:
                try:
                    item = qs[sid].get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    eof.add(sid)
                    break
                if isinstance(item, BaseException):
                    eof.add(sid)
                    backlog[sid].clear()
                    _producer_error(sup, sid, item)
                    break
                backlog[sid].append(item)

    # --------------------------------------------------------------- run ----

    def run(self, params, states: dict, streams: dict, *,
            express_streams=None, express_params=None) -> tuple:
        """Serve ``streams`` to completion; the contract and return shape of
        the round-based ``run_multi``, with bit-identical outputs and final
        states per tenant.

        Express tenants (``express_streams``, a static family: see
        ``run_multi``) join the SAME tick loop: their backlogs admit and
        drain like everyone else's, but they bypass the state pool's
        working-set cap (stateless tenants hold no pages) and each tick's
        ready express slots co-batch into one stateless launch.

        When the run fails (strict supervision, or an error outside
        ``faults.SUPERVISED``), that error is the one that propagates: the
        end-of-run flush still tries to bring the spilled states back, and
        a tenant fault it raises then (a CUDA error that sticks to the
        context fails every later copy too) does not replace it.
        """
        srv = self.srv
        if not srv._use_stream():
            raise ValueError("the continuous scheduler requires the v3 "
                             "stream engine (plan validation enforces this)")
        sids = sorted(streams)
        x_sids = sorted(express_streams or {})
        t_start = time.perf_counter()
        srv._t0_run, srv._commit_ms = t_start, {}
        outs: dict = {sid: [] for sid in sids + x_sids}
        lat: list = []
        ctr = {"live": 0, "padded": 0, "promoted": 0, "launches": 0,
               "timeouts": 0, "degraded": 0, "ticks": 0, "prefill": 0}
        sup = srv._supervisor(sids + x_sids, outs)
        # built before the producers start, so an over-committed pool's
        # first evictions leave no thread behind if they fail
        pool = TenantStatePool(states, srv.state_pool_pages, sup,
                               residency=srv.plan.state_residency)
        qs, pre_ms, stop, threads = srv._spawn_producers(streams)
        if x_sids:
            xqs, x_threads = srv._spawn_express_producers(
                express_streams, stop, pre_ms)
            qs = {**qs, **xqs}
            threads = threads + x_threads
        failed = True
        try:
            with srv._fault_window():
                self._ticks(params, states, qs, outs, lat, ctr, sup, pool,
                            sids, x_sids, express_params)
            failed = False
        finally:
            # every tenant's state returns to the card, wherever its pages
            # lived mid-run; then the deterministic producer shutdown
            try:
                pool.flush()
            except SUPERVISED:
                if not failed:
                    raise
                # the run's own error is already propagating
            finally:
                srv._shutdown(stop, list(qs.values()), threads)
        total = (time.perf_counter() - t_start) * 1e3
        return states, outs, srv._make_stats(lat, pre_ms, total, ctr, sup)

    def _ticks(self, params, states, qs, outs, lat, ctr, sup, pool, sids,
               x_sids, express_params) -> None:
        """The tick loop: admit, pick the ready tenants, page them in,
        launch; until every stream is served or its tenant quarantined."""
        srv = self.srv
        x_set = set(x_sids)
        backlog: dict = {sid: deque() for sid in sids + x_sids}
        eof: set = set()
        last_tick = {sid: 0 for sid in sids + x_sids}
        active = set(sids) | x_set
        tick_no = 0
        while active:
            self._admit(qs, backlog, eof, active, sup)
            for sid in list(active):
                if not sup.ok(sid):
                    backlog[sid].clear()
                    active.discard(sid)
                elif sid in eof and not backlog[sid]:
                    active.discard(sid)  # stream fully served
            ready = [sid for sid in active if backlog[sid]]
            if not ready:
                if active:
                    time.sleep(_IDLE_SLEEP_S)
                continue
            # fairness under pool pressure: least-recently-scheduled first.
            # Only RECURRENT tenants compete for the pool's working set:
            # stateless express tenants hold no pages, so they bypass the
            # cap and ride every tick they have slots ready
            ready.sort(key=lambda s: (last_tick[s], repr(s)))
            x_ready = [s for s in ready if s in x_set]
            ready = [s for s in ready if s not in x_set]
            if pool.capacity is not None:
                # EFFECTIVE capacity (HBM_PAGE_FACTOR x the pages under
                # hbm_paged, serve/state_pool.py)
                ready = ready[:pool.capacity]
            tick_no += 1
            ctr["ticks"] += 1
            x_group: list = []
            for sid in x_ready:
                chunk: list = []
                while backlog[sid] and len(chunk) < srv.stream_chunk:
                    ps, _ = backlog[sid].popleft()
                    chunk.append(ps)
                x_group.append((sid, chunk))
                last_tick[sid] = tick_no
            if x_group:
                srv._run_express_group(express_params, x_group, outs, lat,
                                       ctr, sup)
            chunks: dict = {}
            for sid in ready:
                prefill = (srv.prefill_chunk is not None
                           and len(backlog[sid]) > srv.stream_chunk)
                quota = srv.prefill_chunk if prefill else srv.stream_chunk
                chunk: list = []
                dims: list = []
                while backlog[sid] and len(chunk) < quota:
                    ls, d = backlog[sid].popleft()
                    chunk.append(ls)
                    dims.append(d)
                chunks[sid] = (chunk, dims)
                if prefill:
                    ctr["prefill"] += 1
                last_tick[sid] = tick_no
            # page the tick's working set in BEFORE any checkpoint is
            # taken; evicts LRU tenants outside the set
            pool.acquire(list(chunks))
            groups: dict = {}
            for sid, (chunk, dims) in sorted(chunks.items()):
                bucket = srv._chunk_bucket(dims)
                groups.setdefault(bucket, []).append((sid, chunk, bucket))
            if srv.promote_buckets is not None and srv.buckets is not None:
                before = {b: len(m) for b, m in groups.items()}
                groups = promote_bucket_groups(
                    groups, srv.buckets, srv.promote_buckets,
                    cost=srv._promotion_cost(params))
                ctr["promoted"] += sum(len(m) - before.get(b, 0)
                                       for b, m in groups.items())
            for bucket in sorted(groups):
                srv._run_group_supervised(params, states, groups[bucket],
                                          outs, lat, ctr, sup)
