"""DGNN snapshot-stream serving engine — the paper's deployment mode.

The paper's §IV-D task split, on a host and one CUDA card:

  host threads ("CPU tasks"): validate each raw COO snapshot, renumber and
    normalize it, build its ELL rows and pad it into its bucket — numpy
    work only, one producer thread a tenant;
  device loop ("FPGA tasks"): pulls prepared snapshots from bounded
    queues, moves each stacked chunk to the device once, launches, and
    reads the outputs back to the host — every CUDA call (copies,
    launches, synchronization) stays on this one thread.

Bucketed padding: with the plan's ``buckets``, each snapshot is padded into
the smallest bucket that fits (graph/padding.choose_bucket) instead of the
worst-case shape.

V3 fast path (plan level "v3"): consecutive same-bucket snapshots are
batched into chunks of up to ``stream_chunk`` and the WHOLE chunk goes to
the family's stream engine in one launch (``step_stream_batched`` with
ragged ``lengths``), so the recurrent state crosses device memory once a
chunk. On the card that launch is the family's cluster engine
(``gcrn_engine``, ``evolve_engine``, ``stacked_engine``, or their paged
variants where the plan pages); on the CPU it is their plain versions.

Multi-tenant serving (``run_multi``): each tenant stream gets its own
producer thread and recurrent state; the device loop runs rounds,
co-buckets each stream's next chunk (choose_bucket_batch), groups
same-bucket chunks across tenants and hands each group to ONE batched
launch: B streams, one launch, one weight load. Chunk T and batch B are
padded to powers of two as in the JAX package (there they bound its jit
cache; here they keep ``live_snapshots`` / ``padded_snapshots`` /
``launches`` equal to the JAX server's for the same plan and streams), and
the dead slots are masked in-launch by ``lengths``.

Cross-bucket batching (``promote_buckets``): a round's smaller-bucket
chunks may be promoted into the next-larger occupied bucket, guarded by a
max padded-cost ratio: the static ``bucket_cost`` proxy, or with
``promotion_guard="measured"`` per-bucket step times from a warmup
calibration (one timed launch of an empty chunk a bucket).

The express lane: a second, STATIC-family session (``express=``) serves
stateless tenants; every express snapshot is a T=1 slot on the batch axis
of one ``static_engine`` launch a round, with no checkpoint around it.

Fault isolation and recovery: every chunk launch goes through a SUPERVISED
runner. Snapshots are validated at the serve boundary
(serve/faults.validate_snapshot); per-tenant state is checkpointed before
each chunk commit and rolled back on any failure (serve/supervision.py
says why a reference checkpoint is complete here); failed launches are
retried with exponential backoff (``max_retries`` / ``retry_backoff_ms``),
bounded by a deadline enforced on completion (``launch_timeout_ms``, the
device synchronized; the first launch of each shape is exempt); a
persistent fault attributable to one tenant quarantines that tenant
(``supervision="isolate"``) while its co-batched tenants are retried
without it; an unattributable failure walks the DEGRADATION LADDER
(``degrade=True``): batched -> solo -> the plain PyTorch oracle on the
same device (the kernels/ops force-ref gate), which only a typed
``ServeFault`` reaches: a kernel that fails to build, load or launch is
quarantined or raised, never served by the plain path. Every recovery
action is counted in ``ServeStats``. The fault plan (``fault_plan`` ->
serve/faults.FaultInjector) drives each site on demand; the launch site
fires from the kernels/ops fault hook, on the host, before each launch.

What a supervised step catches is ``faults.SUPERVISED``, not every
exception (the JAX package catches ``Exception``): anything else — a
programming fault — propagates out of ``run`` / ``run_multi`` after the
producer threads are shut down.

Continuous batching (``scheduler="continuous"``, serve/scheduler.py):
``run_multi`` hands over to ``ContinuousScheduler``, which composes each
launch from whatever snapshots are ready (no round barrier), serves a
backlog ``prefill_chunk`` snapshots a tick, and keeps per-tenant state in a
paged pool (``state_pool_pages``, serve/state_pool.py) that spills the
least-recently-scheduled tenants to the host. Its outputs and final states
equal the round scheduler's bit for bit. A committed tenant state owns its
storage (``_commit_group``), so a spilled tenant frees its bytes on the
card.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core.dataflow import _stack_states, stack_time
from repro_torch.graph.coo import COOSnapshot
from repro_torch.graph.csr import max_in_degree, renumber_and_normalize
from repro_torch.graph.padding import (
    PaddedSnapshot,
    bucket_cost,
    choose_bucket,
    choose_bucket_batch,
    empty_padded,
    pad_snapshot,
    pow2_target,
    promote_bucket_groups,
    stack_streams,
)
from repro_torch.kernels import ops as kops
from repro_torch.serve.faults import (SUPERVISED, LaunchTimeout, ServeFault,
                                      validate_snapshot)
from repro_torch.serve.supervision import (SupervisionPolicy, TenantSupervisor,
                                           map_state)

# sid the single-tenant ``run`` path supervises its stream under
SOLO_SID = "stream"

# how long shutdown keeps drain-joining producer threads before giving up
# with a warning (a thread cannot be killed in Python; a producer stuck in
# user iterator code past this is reported, not silently leaked)
_SHUTDOWN_DEADLINE_S = 5.0


@dataclass
class ServeStats:
    per_snapshot_ms: list
    preprocess_ms: list
    total_ms: float
    # how many snapshot slots of the batched V3 launches were real vs
    # padding (T tails and batch-padding rows), so promoted-bucket rows
    # show their padding overhead instead of hiding it in throughput
    live_snapshots: int = 0
    padded_snapshots: int = 0
    promoted_chunks: int = 0  # chunks promoted to a larger bucket
    launches: int = 0         # stream-engine launches (v3 paths)
    # express-lane launches; ``launches_by_family`` splits ALL launches by
    # stream family (express launches count under static_gcn too)
    express_launches: int = 0
    launches_by_family: dict = field(default_factory=dict)
    # fault isolation / recovery
    retries: int = 0            # failed chunk attempts that were replayed
    rollbacks: int = 0          # per-tenant state rollbacks
    degraded_launches: int = 0  # solo / oracle ladder launches that served
    timeouts: int = 0           # launches past the plan deadline
    # per-tenant outcomes: {sid: supervision.TenantResult}
    tenants: dict = field(default_factory=dict)
    # measured-guard calibration fell back to the static proxy (repr of
    # the LAST error; None = calibration ok or never requested)
    calibration_fallback: Optional[str] = None
    # continuous-scheduler signals (0 under the round scheduler)
    ticks: int = 0
    prefill_chunks: int = 0
    evictions: int = 0
    recoveries: int = 0
    # per-tenant commit timestamps: {sid: [ms since run start, one per
    # committed snapshot, in stream order]}
    commit_ms: dict = field(default_factory=dict)

    @property
    def mean_latency_ms(self) -> float:
        return float(np.mean(self.per_snapshot_ms)) if self.per_snapshot_ms else 0.0

    @property
    def tenant_errors(self) -> dict:
        """{sid: error} for every quarantined tenant."""
        return {sid: r.error for sid, r in self.tenants.items() if not r.ok}


class _HandOff:
    """A producer thread's guard: whatever its body raises is put on the
    tenant's queue instead of ending the thread silently, so the device
    loop never waits on a dead producer. The device loop treats a
    ``SUPERVISED`` error as the tenant's fault and re-raises anything else
    after the clean shutdown."""

    def __init__(self, put):
        self._put = put

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb):
        if exc is not None:
            self._put(exc)
        return True


def _producer_error(sup: TenantSupervisor, sid, exc: BaseException) -> None:
    """A producer's error reaching the device loop: a tenant fault is
    quarantined (isolate) or raised (strict); anything else is raised."""
    if not isinstance(exc, SUPERVISED):
        raise exc
    sup.quarantine(sid, exc, site=getattr(exc, "site", None))


class SnapshotServer:
    """Streaming DGNN inference over snapshot iterators.

    A consumer of ``repro_torch.api.BoosterSession``: all policy — dataflow
    level, buckets, chunking, promotion, fault isolation and recovery —
    comes from the session's typed ``StreamPlan``, and the server lives on
    the session's device. The historical keyword surface (cfg + mode +
    padding kwargs) is a deprecated shim that builds the equivalent plan
    and session on ``device`` (the card by default).
    """

    def __init__(self, cfg: Optional[DGNNConfig] = None,
                 feat_table: Optional[np.ndarray] = None,
                 n_global: Optional[int] = None,
                 mode: Optional[str] = None,
                 n_pad: int = 640, e_pad: int = 4096, k_max: int = 64,
                 queue_depth: int = 2,
                 buckets: Optional[tuple] = None,
                 stream_chunk: int = 8,
                 promote_buckets: Optional[float] = None,
                 promotion_guard: str = "static",
                 scheduler: str = "rounds",
                 state_pool_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, *,
                 plan=None, session=None, express=None, device="cuda"):
        from repro_torch import api

        if session is None:
            warnings.warn(
                "the SnapshotServer keyword surface (cfg + mode + padding "
                "kwargs) is deprecated: build a typed plan and pass "
                "SnapshotServer(session=BoosterSession(cfg, plan, ...))",
                DeprecationWarning, stacklevel=2)
            if cfg is None:
                raise ValueError("SnapshotServer needs a BoosterSession "
                                 "(session=) or a DGNNConfig")
            if n_global is None:
                raise ValueError("SnapshotServer needs n_global (the "
                                 "global node-store size) on the config "
                                 "surface — an undersized default would "
                                 "silently scatter-drop high node ids")
            if plan is None:
                # deprecated keyword surface -> the equivalent typed plan
                plan = api.plan(
                    cfg, level=mode if mode is not None else cfg.dataflow,
                    n_pad=n_pad, e_pad=e_pad, k_max=k_max,
                    queue_depth=queue_depth, buckets=buckets,
                    stream_chunk=stream_chunk,
                    promote_buckets=promote_buckets,
                    promotion_guard=promotion_guard,
                    scheduler=scheduler,
                    state_pool_pages=state_pool_pages,
                    prefill_chunk=prefill_chunk)
            session = api.BoosterSession(cfg, plan, n_global=n_global,
                                         feat_table=feat_table, device=device)
        self.session = session
        self.plan = session.plan
        if self.plan.device.n_devices > 1:
            # the serve loops pick their own launch batch sizes (B=1
            # chunks, pow2 tenant rounds), which need not divide n_devices
            raise ValueError(
                "DeviceSpec sharding is a batched-launch capability "
                "(BoosterSession.run_batched / api.run_arrays); the "
                "serving engine does not shard its launches")
        self.cfg = session.cfg
        self.model = session.model
        self.device = session.device
        self.force_ref = session.force_ref
        self.feat_table = (feat_table if feat_table is not None
                           else session.feat_table)
        if self.feat_table is None:
            raise ValueError("SnapshotServer needs the global feat_table")
        # plan-derived knobs (kept as attributes for callers / tests)
        self.mode = self.plan.level
        self.n_pad, self.e_pad = self.plan.n_pad, self.plan.e_pad
        self.k_max = self.plan.k_max
        self.buckets = self.plan.buckets
        self.stream_chunk = self.plan.stream_chunk
        self.queue_depth = self.plan.queue_depth
        self.promote_buckets = self.plan.promote_buckets
        self.scheduler = self.plan.scheduler
        self.state_pool_pages = self.plan.state_pool_pages
        self.prefill_chunk = self.plan.prefill_chunk
        self._bucket_ms: Optional[dict] = None  # measured-guard calibration
        self._calib_error: Optional[str] = None  # fallback-to-static reason
        self._policy = SupervisionPolicy.from_plan(self.plan)
        self._injector = (self.plan.fault_plan.injector()
                          if self.plan.fault_plan is not None else None)
        self._fault_exempt = False   # calibration launches skip probes
        self._launch_ctx: tuple = ()  # live sids of the in-flight launch
        self._warmed: set = set()    # launch signatures past their first
        self._t0_run = 0.0           # run-start clock for commit stamps
        self._commit_ms: dict = {}   # {sid: [commit ms since run start]}
        # ------------------------------------------------ express lane ----
        # a second, STATIC-family session: its tenants are stateless, so
        # their snapshots co-batch — each an independent T=1 slot of a
        # dedicated launch with no checkpoint/rollback around it
        self.express = express
        if express is not None:
            if express.plan.temporal != "static":
                raise ValueError(
                    "express= takes a BoosterSession of a STATIC-temporal "
                    f"family; {express.model.stream_family!r} declares "
                    f"temporal={express.plan.temporal!r}")
            if express.plan.level != "v3":
                raise ValueError("the express lane is a stream-engine "
                                 "path: the express plan must be level "
                                 f"'v3', got {express.plan.level!r}")
            if express.plan.device.n_devices > 1:
                raise ValueError("the express lane does not shard its "
                                 "launches (see the session sharding note "
                                 "above)")
            if express.plan.buckets is not None:
                raise ValueError(
                    "the express lane co-batches every static slot into "
                    "ONE shape; give the express plan a fixed bucket "
                    "(buckets=None)")
            if express.device != self.device:
                raise ValueError(
                    f"the express session is on {express.device}, the "
                    f"server on {self.device}: one device serves both")
            self._express_feat = (express.feat_table
                                  if express.feat_table is not None
                                  else self.feat_table)

    def init(self, gen):
        """(Re)initialize the session's params from ``gen`` (a
        torch.Generator) and a fresh state; returns ``(params, state)``."""
        return self.session.init(gen)

    # ---------------------------------------------------- device work ----

    def _sync(self) -> None:
        """Wait for the device's queued work, so a clock read after it
        times finished work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, params, state, ps: PaddedSnapshot):
        """One snapshot at a per-step level (baseline / o1 / v1 / v2)."""
        return self.model.step(params, state, ps.to(self.device),
                               mode=self.mode, force_ref=self.force_ref)

    def _express_step(self, params_x, slots: PaddedSnapshot, lengths: list):
        """One express-lane launch over (B, 1) static slots."""
        xp = self.express.plan
        return self.express.model.step_stream_batched(
            params_x, {}, slots.to(self.device), tn=xp.tn, td=xp.td,
            lengths=lengths, force_ref=self.express.force_ref)[1]

    # ------------------------------------------------- fault injection ----

    def _probe(self, site: str, tenant=None) -> None:
        """Host-side fault-site probe (preprocess / bucket / evolve sites;
        launch-site probes fire from the kernels/ops fault hook).

        Deliberately does NOT consult ``_fault_exempt``: calibration never
        reaches a host site, but it flips that flag on the device loop
        while producer threads run host probes concurrently — gating here
        would let a calibration window swallow a concurrent tenant's
        preprocess / bucket occurrence counts. Only ``_launch_probe`` is
        gated, and only calibration launches run under the flag, on the
        same thread that sets it."""
        if self._injector is not None:
            self._injector.probe(
                site, tenants=() if tenant is None else (tenant,))

    def _launch_probe(self, *, family, batched, force_ref) -> None:
        """The kernels/ops fault hook: fires on the host before every
        stream-engine launch, with the engine supplying the live-tenant
        context of the in-flight launch."""
        del family, batched  # scope is judged on live tenants, not shape
        if self._injector is None or self._fault_exempt:
            return
        sids = self._launch_ctx
        self._injector.probe("launch", tenants=sids, n_live=len(sids),
                             force_ref=force_ref)

    @contextmanager
    def _fault_window(self):
        """Install the ops-layer launch hook for the duration of a serve
        run (only when the fault plan addresses the launch site), and
        restore the previous hook on every exit path."""
        if (self._injector is None
                or "launch" not in self.plan.fault_plan.sites()):
            yield
            return
        prev = kops.set_fault_hook(self._launch_probe)
        try:
            yield
        finally:
            kops.set_fault_hook(prev)

    def _attribution(self, exc: BaseException) -> BaseException:
        """Map a launch exception to its root fault: the fault the
        injector fired last, if any; otherwise the exception itself."""
        if self._injector is not None:
            fired = self._injector.take_fired()
            if fired is not None:
                return fired
        return exc

    # ------------------------------------------------------ host thread ----

    def _preprocess(self, snap: COOSnapshot,
                    tenant=SOLO_SID) -> PaddedSnapshot:
        # a snapshot that fits no bucket raises here (on the producer
        # thread) and reaches the device loop through the queue
        self._probe("preprocess", tenant=tenant)
        validate_snapshot(snap, self.feat_table.shape[0], tenant=tenant)
        ls = renumber_and_normalize(snap)
        if self.buckets is not None:
            self._probe("bucket", tenant=tenant)
            n_pad, e_pad, k_max = choose_bucket(
                ls.n_nodes, ls.src.shape[0], max_in_degree(ls), self.buckets)
        else:
            n_pad, e_pad, k_max = self.n_pad, self.e_pad, self.k_max
        return pad_snapshot(ls, self.feat_table, n_pad, e_pad, k_max)

    # -------------------------------------------------------- shutdown ----

    @staticmethod
    def _drain(q: queue.Queue) -> None:
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass

    def _shutdown(self, stop: threading.Event, queues: list,
                  threads: list) -> None:
        """Deterministic producer shutdown, run on EVERY exit path: signal
        stop, then drain-join until every producer thread has exited (a
        producer blocked on a full queue wakes on the drain; one blocked
        on the stop-aware put wakes on the event). A thread still alive
        past the deadline is stuck in user iterator code — warned about,
        since Python offers no way to kill it."""
        stop.set()
        deadline = time.perf_counter() + _SHUTDOWN_DEADLINE_S
        alive = [th for th in threads if th.is_alive()]
        while alive and time.perf_counter() < deadline:
            for q in queues:
                self._drain(q)
            for th in alive:
                th.join(timeout=0.05)
            alive = [th for th in alive if th.is_alive()]
        for th in alive:
            warnings.warn(f"serve producer thread {th.name!r} did not exit "
                          "within the shutdown deadline (stuck in the "
                          "stream iterator?)", RuntimeWarning)

    # ------------------------------------------------------ device loop ----

    def _use_stream(self) -> bool:
        # level v3 requires the model's family to have a stream engine
        # (all five do); an unknown family is LOUD, never a silent
        # per-snapshot fallback
        if self.mode != "v3":
            return False
        if self.model.stream_family not in kops.stream_families():
            raise KeyError(
                f"plan level 'v3' but family {self.model.stream_family!r} "
                f"has no stream engine; registered: "
                f"{list(kops.stream_families())}")
        return True

    def _launch_ragged(self, params, states_B, per_stream: list,
                       lengths, force_ref: bool = False):
        """ONE batched ragged-T stream launch: ``per_stream`` are (T, ...)
        stacked host chunks of equal padded shape, moved to the device
        here in one (B, T, ...) batch; ``lengths`` their true live lengths
        (0 = pure batch-padding row), masked in-launch. ``force_ref``
        routes to the plain PyTorch oracle (the degraded-mode rung)."""
        batch_BT = stack_streams(per_stream).to(self.device)
        p = self.plan
        return self.model.step_stream_batched(
            params, states_B, batch_BT, tn=p.tn, td=p.td,
            lengths=[int(t) for t in lengths],
            state_residency=p.state_residency, buffer_depth=p.buffer_depth,
            force_ref=force_ref or self.force_ref)

    # -------------------------------------------------- supervised launch ----

    def _count_launch(self, ctr: dict, family: str) -> None:
        ctr["launches"] += 1
        bf = ctr.setdefault("by_family", {})
        bf[family] = bf.get(family, 0) + 1

    def _stage_group(self, params, states: dict, group: list,
                     force_ref: bool = False) -> tuple:
        """Launch one batched V3 group WITHOUT committing anything: build
        the (B, T) batch, run it, and return the staged per-tenant results
        ``(staged_states, staged_outs, dt_per_snapshot_ms, live, padded)``.
        Commit / rollback is the supervised runner's job, so a failure
        here (or after, in the commit phase) leaves tenant state
        untouched.

        ``group`` is [(sid, [LocalSnapshot | PaddedSnapshot, ...],
        bucket), ...]. Each stream's chunk is padded to the shared bucket
        and stacked to a (B, T, ...) batch with the per-stream states
        alongside; T is the common power-of-two target and the batch axis
        is pow2-padded too. Raggedness is carried by ``lengths`` and
        masked in-launch. Row b of the launch result is that stream's
        output in stream order, read back to the host as numpy.

        The plan's ``launch_timeout_ms`` deadline is enforced on
        completion: the launch is timed up to a device synchronize, and an
        overdue result raises ``LaunchTimeout`` and is DISCARDED by the
        caller. The first launch of each (bucket, T, B, route) signature
        is exempt: on the card it may build the family's kernel library
        (``engine.build`` at first use runs nvcc) and pays its first
        launch's set-up.
        """
        bucket = group[0][2]
        real_lens = [len(chunk) for _, chunk, _ in group]
        target = pow2_target(max(real_lens), cap=self.stream_chunk)
        b_real = len(group)
        b_target = pow2_target(b_real)
        per_stream = []
        for _, chunk, _ in group:
            # fixed-bucket items arrive pre-padded from the producer thread
            # (host-prep overlap); bucketed items pad here, once the chunk
            # bucket is known
            padded = [ls if isinstance(ls, PaddedSnapshot)
                      else pad_snapshot(ls, self.feat_table, *bucket)
                      for ls in chunk]
            # ragged T: tail slots repeat the last snapshot — dead
            # ``lengths`` slots, masked in-launch, content irrelevant
            padded = padded + [padded[-1]] * (target - len(padded))
            per_stream.append(stack_time(padded))
        # batch-axis padding = length-0 streams (results discarded)
        per_stream.extend([per_stream[0]] * (b_target - b_real))
        lengths = real_lens + [0] * (b_target - b_real)
        zero_state = map_state(torch.zeros_like, states[group[0][0]])
        # a fresh (B, ...) batch: the launch never sees a tenant's tensors
        states_B = _stack_states([states[sid] for sid, _, _ in group]
                                 + [zero_state] * (b_target - b_real))
        key = (bucket, target, b_target, force_ref)
        warmed = key in self._warmed
        self._launch_ctx = tuple(sid for sid, _, _ in group)
        try:
            t0 = time.perf_counter()
            states_B, out_BT = self._launch_ragged(params, states_B,
                                                   per_stream, lengths,
                                                   force_ref=force_ref)
            self._sync()
            dt_ms = (time.perf_counter() - t0) * 1e3
        finally:
            self._launch_ctx = ()
        self._warmed.add(key)
        timeout = self._policy.timeout_ms
        if timeout is not None and warmed and dt_ms > timeout:
            raise LaunchTimeout(
                f"launch took {dt_ms:.1f}ms > launch_timeout_ms={timeout}"
                f" (bucket={bucket}, B={b_target}, T={target}); result "
                "discarded", site="launch")
        out_np = out_BT.cpu().numpy()
        staged_states = {
            sid: map_state(lambda a, b=b: a[b], states_B)
            for b, (sid, _, _) in enumerate(group)}
        staged_outs = {sid: [out_np[b, t] for t in range(real_lens[b])]
                       for b, (sid, _, _) in enumerate(group)}
        live = sum(real_lens)
        padded_slots = b_target * target - live
        return staged_states, staged_outs, dt_ms / live, live, padded_slots

    def _commit_group(self, states: dict, group: list, staged: tuple,
                      outs: dict, lat: list, ctr: dict, sup: TenantSupervisor,
                      degraded: bool = False) -> None:
        """Commit one staged group: the ``evolve`` fault site sits inside
        the state-commit loop, so an injected (or real) mid-commit failure
        leaves ``states`` partially written — exactly what the
        supervisor's checkpoint / rollback must undo for the replay to
        evolve state exactly once per served snapshot."""
        staged_states, staged_outs, dt, live, padded_slots = staged
        for sid, _, _ in group:
            self._probe("evolve", tenant=sid)
            # a copy of the tenant's rows, not a view into the launch's
            # (B, ...) batch: a view would keep the whole batch alive for as
            # long as any co-batched tenant's state lives, so the state pool
            # could bound nothing and an evicted tenant would free nothing
            states[sid] = map_state(torch.clone, staged_states[sid])
        # commit wall-clock (ms since run start) recorded per snapshot —
        # only after the whole evolve loop, so a rolled-back commit never
        # stamps timestamps for outputs it did not serve
        now_ms = (time.perf_counter() - self._t0_run) * 1e3
        for sid, chunk, _ in group:
            outs[sid].extend(staged_outs[sid])
            self._commit_ms.setdefault(sid, []).extend([now_ms] * len(chunk))
            lat.extend([dt] * len(chunk))
            if degraded:
                sup.note_degraded(sid)
        ctr["live"] += live
        ctr["padded"] += padded_slots
        if degraded:
            ctr["degraded"] += 1

    def _degrade_group(self, params, states: dict, members: list,
                       outs: dict, lat: list, ctr: dict,
                       sup: TenantSupervisor, cause: BaseException) -> None:
        """The degradation ladder's lower rungs, per member: a solo (B=1)
        v3 launch isolates the batch from a poisoned co-tenant; if the
        kernel path itself is the fault, the plain PyTorch oracle
        (force-ref gate, same device) serves correct-but-slower results. A
        member that fails every rung is quarantined (isolate) or raises
        (strict) with the LAST error as cause.

        Only a typed ``ServeFault`` (an injected fault, a launch timeout)
        opens the oracle rung. A kernel that fails to build, load or
        launch raises a plain error, and its member is quarantined or the
        error raised: the plain path never stands in for a broken kernel."""
        static = self.plan.temporal == "static"
        for member in members:
            sid = member[0]
            err = cause
            for force_ref in (False, True):
                ckpt = None if static else sup.checkpoint(states, [sid])
                try:
                    self._count_launch(ctr, self.model.stream_family)
                    staged = self._stage_group(params, states, [member],
                                               force_ref=force_ref)
                    self._commit_group(states, [member], staged, outs, lat,
                                       ctr, sup, degraded=True)
                    err = None
                    break
                except SUPERVISED as exc:
                    err = self._attribution(exc)
                    if isinstance(err, LaunchTimeout):
                        ctr["timeouts"] += 1
                    if ckpt is not None:
                        sup.rollback(states, ckpt)
                    if not isinstance(err, ServeFault):
                        break  # a broken kernel: no oracle rung
            if err is not None:
                sup.quarantine(sid, err,
                               site=getattr(err, "site", "launch"))

    def _run_group_supervised(self, params, states: dict, group: list,
                              outs: dict, lat: list, ctr: dict,
                              sup: TenantSupervisor) -> None:
        """One batched V3 group under the supervision contract:

          1. checkpoint every member's recurrent state;
          2. stage the batched launch + commit (the happy path);
          3. on failure: roll back, then retry the SAME group up to
             ``max_retries`` times with exponential backoff (a transient
             fault is survived in place, replaying from the checkpoint);
          4. retries exhausted + fault attributable to one member: that
             tenant is quarantined and the remaining members are retried
             without it;
          5. retries exhausted + unattributable: walk the degradation
             ladder (plan ``degrade=True``), else quarantine the whole
             group (isolate) / raise (strict).
        """
        members = [m for m in group if sup.ok(m[0])]
        attempt = 0
        # a static family's state is empty and never advances: nothing to
        # checkpoint, on the regular path as in the express lane
        static = self.plan.temporal == "static"
        while members:
            sids = [sid for sid, _, _ in members]
            ckpt = None if static else sup.checkpoint(states, sids)
            try:
                self._count_launch(ctr, self.model.stream_family)
                staged = self._stage_group(params, states, members)
                self._commit_group(states, members, staged, outs, lat, ctr,
                                   sup)
                return
            except SUPERVISED as exc:
                err = self._attribution(exc)
                if isinstance(err, LaunchTimeout):
                    ctr["timeouts"] += 1
                if ckpt is not None:
                    sup.rollback(states, ckpt)
                attempt += 1
                if attempt <= self._policy.max_retries:
                    sup.note_retry(sids, attempt)
                    continue
                tenant = getattr(err, "tenant", None)
                if tenant is not None and tenant in sids:
                    # persistent fault pinned to one member: quarantine it,
                    # retry the healthy co-batch without it
                    sup.quarantine(tenant, err,
                                   site=getattr(err, "site", "launch"))
                    members = [m for m in members if m[0] != tenant]
                    attempt = 0
                    continue
                if self._policy.degrade:
                    self._degrade_group(params, states, members, outs, lat,
                                        ctr, sup, err)
                    return
                # no ladder: the whole group fails together
                for sid in sids:
                    sup.quarantine(sid, err,
                                   site=getattr(err, "site", "launch"))
                return

    def _run_chunk(self, params, states: dict, chunk: list, outs: dict,
                   lat: list, ctr: dict, sup: TenantSupervisor) -> None:
        """Feed one same-bucket single-tenant chunk to the stream engine
        (a B=1 supervised launch). Short flushes (the stream's tail, or a
        bucket change) pad T up to the next power of two, not all the way
        to ``stream_chunk``; the tail repeats the last snapshot and is
        masked by ``lengths``."""
        bucket = (chunk[0].n_pad, chunk[0].e_pad, chunk[0].k_max)
        self._run_group_supervised(params, states,
                                   [(SOLO_SID, chunk, bucket)], outs, lat,
                                   ctr, sup)

    def _make_stats(self, lat, pre_ms, total, ctr,
                    sup: Optional[TenantSupervisor]) -> ServeStats:
        totals = sup.totals() if sup is not None else {}
        return ServeStats(
            lat, pre_ms, total,
            live_snapshots=ctr["live"], padded_snapshots=ctr["padded"],
            promoted_chunks=ctr["promoted"], launches=ctr["launches"],
            express_launches=ctr.get("express", 0),
            launches_by_family=dict(ctr.get("by_family", {})),
            retries=totals.get("retries", 0),
            rollbacks=totals.get("rollbacks", 0),
            degraded_launches=totals.get("degraded_launches", 0),
            timeouts=ctr.get("timeouts", 0),
            tenants=dict(sup.results) if sup is not None else {},
            calibration_fallback=self._calib_error,
            ticks=ctr.get("ticks", 0),
            prefill_chunks=ctr.get("prefill", 0),
            evictions=totals.get("evictions", 0),
            recoveries=totals.get("recoveries", 0),
            commit_ms=dict(self._commit_ms))

    def _supervisor(self, sids, outputs: dict) -> TenantSupervisor:
        return TenantSupervisor(sids, self._policy, outputs=outputs,
                                device=self.device)

    def run(self, params, state, snaps: Iterable[COOSnapshot]) -> tuple:
        """Returns (final_state, outputs list, ServeStats).

        Single-tenant edition of the supervision contract: the stream is
        supervised under the sid ``"stream"`` — with the default strict
        policy every failure raises (after a clean shutdown); with plan
        ``supervision="isolate"`` a terminal failure stops the stream and
        returns the partial outputs with the error recorded in
        ``stats.tenants["stream"]``.
        """
        # the v3 device loop consumes ``stream_chunk`` snapshots a launch:
        # size the queue for a full chunk ahead so the producer keeps the
        # host/device overlap; per-snapshot levels keep queue_depth
        depth = (max(self.queue_depth, self.stream_chunk)
                 if self._use_stream() else self.queue_depth)
        q: queue.Queue = queue.Queue(maxsize=depth)
        pre_ms: list = []
        stop = threading.Event()

        def _put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with _HandOff(_put):
                for s in snaps:
                    t0 = time.perf_counter()
                    ps = self._preprocess(s)
                    pre_ms.append((time.perf_counter() - t0) * 1e3)
                    if not _put(ps):
                        return
                _put(None)

        th = threading.Thread(target=producer, daemon=True,
                              name=f"dgnn-serve-producer-{SOLO_SID}")
        t_start = time.perf_counter()
        self._t0_run, self._commit_ms = t_start, {}
        th.start()
        outs: list = []
        lat: list = []
        ctr = {"live": 0, "padded": 0, "promoted": 0, "launches": 0,
               "timeouts": 0, "degraded": 0}
        sup = self._supervisor([SOLO_SID], {SOLO_SID: outs})
        states = {SOLO_SID: state}
        outs_d = {SOLO_SID: outs}
        use_stream = self._use_stream()
        chunk: list = []
        try:
            with self._fault_window():
                while sup.ok(SOLO_SID):
                    ps = q.get()
                    if ps is None:
                        break
                    if isinstance(ps, BaseException):
                        # e.g. validation / no-fit bucket: strict raises,
                        # isolate records and stops the stream
                        _producer_error(sup, SOLO_SID, ps)
                        break
                    if not use_stream:
                        ckpt = sup.checkpoint(states, [SOLO_SID])
                        try:
                            t0 = time.perf_counter()
                            states[SOLO_SID], out = self._step(
                                params, states[SOLO_SID], ps)
                            self._sync()
                            lat.append((time.perf_counter() - t0) * 1e3)
                            outs.append(out.cpu().numpy())
                        except SUPERVISED as exc:
                            sup.rollback(states, ckpt)
                            sup.quarantine(SOLO_SID, self._attribution(exc))
                        continue
                    # v3: gather same-bucket runs into chunks
                    bucket = (ps.n_pad, ps.e_pad, ps.k_max)
                    if chunk and (chunk[0].n_pad, chunk[0].e_pad,
                                  chunk[0].k_max) != bucket:
                        self._run_chunk(params, states, chunk, outs_d, lat,
                                        ctr, sup)
                        chunk = []
                    chunk.append(ps)
                    if len(chunk) == self.stream_chunk:
                        self._run_chunk(params, states, chunk, outs_d, lat,
                                        ctr, sup)
                        chunk = []
                if chunk and sup.ok(SOLO_SID):
                    self._run_chunk(params, states, chunk, outs_d, lat, ctr,
                                    sup)
        finally:
            self._shutdown(stop, [q], [th])
        total = (time.perf_counter() - t_start) * 1e3
        return states[SOLO_SID], outs, self._make_stats(lat, pre_ms, total,
                                                        ctr, sup)

    # ------------------------------------------- multi-tenant device loop ----

    def _chunk_bucket(self, dims: list) -> tuple:
        """Bucket covering a whole chunk of (n, e, k) dims (one shape a
        chunk, so the chunk can batch with same-bucket chunks of other
        streams)."""
        if self.buckets is not None:
            return choose_bucket_batch(dims, self.buckets)
        return (self.n_pad, self.e_pad, self.k_max)

    # ------------------------------------------- promotion cost guard ----

    def _calibrate_bucket_times(self, params) -> Optional[dict]:
        """Measure the stream engine's step time per bucket with a tiny
        warmup: one empty-snapshot B=1 chunk a bucket, launched once to
        warm, then timed up to a device synchronize. The measured times
        replace the static ``bucket_cost`` proxy in the promotion guard
        (plan ``promotion_guard="measured"``); returns None (static
        fallback) if any bucket fails to calibrate — the fallback is
        WARNED about and recorded in ``ServeStats.calibration_fallback``.

        Calibration launches are warm-up, not serving: they go straight
        through ``_launch_ragged`` (never ``_stage_group``), so they touch
        neither ``ServeStats.launches`` nor ``per_snapshot_ms``, and the
        ``_fault_exempt`` window keeps them out of launch-site occurrence
        counting. They do count in the kernel wrappers' launch counters
        (two a bucket). An empty chunk has no live tile, so on the card
        its time is mostly launch overhead."""
        din = self.feat_table.shape[1]
        de = self.cfg.edge_dim
        T = pow2_target(self.stream_chunk, cap=self.stream_chunk)
        times: dict = {}
        self._fault_exempt = True  # calibration is not a serve launch
        try:
            for bucket in self.buckets:
                chunk = [empty_padded(*bucket, din, de)] * T
                state = self.model.init_state(params, mode=self.mode)
                state_B = map_state(lambda a: a[None], state)
                run = lambda: self._launch_ragged(
                    params, state_B, [stack_time(chunk)], [T])
                run()  # warm
                self._sync()
                t0 = time.perf_counter()
                run()
                self._sync()
                times[bucket] = max((time.perf_counter() - t0) * 1e3 / T,
                                    1e-6)
        except SUPERVISED as exc:
            self._calib_error = repr(exc)
            warnings.warn(
                "measured promotion-guard calibration failed; falling back "
                f"to the static bucket_cost proxy: {exc!r}", RuntimeWarning)
            return None  # static proxy fallback
        finally:
            self._fault_exempt = False
        return times

    def _measured_cost(self, bucket: tuple) -> float:
        """Per-bucket cost under the measured guard: every group's bucket
        is one of ``self.buckets``, and calibration timed each of them."""
        return self._bucket_ms[bucket]

    def _promotion_cost(self, params):
        """Cost function for promote_bucket_groups: measured per-bucket
        step times when the plan asks for the adaptive guard (calibrated
        lazily, once), else the static padded-compute proxy."""
        if self.plan.promotion_guard != "measured":
            return bucket_cost
        if self._bucket_ms is None and self._calib_error is None:
            self._bucket_ms = self._calibrate_bucket_times(params)
        if self._bucket_ms is None:
            return bucket_cost  # calibration failed: static fallback
        return self._measured_cost

    def _spawn_producers(self, streams: dict) -> tuple:
        """Start one host preprocessing thread per tenant stream. Returns
        ``(queues, pre_ms, stop_event, threads)`` with the threads already
        running. Each queue carries ``(LocalSnapshot | PaddedSnapshot,
        dims)`` items in stream order, then ``None`` at end-of-stream — or
        the exception the producer raised (validation, no-fit bucket,
        injected fault), which the device loop turns into a quarantine /
        raise per policy."""
        sids = sorted(streams)
        qs = {sid: queue.Queue(maxsize=max(self.queue_depth,
                                           self.stream_chunk))
              for sid in sids}
        pre_ms: list = []
        stop = threading.Event()

        def _put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(sid):
            with _HandOff(lambda exc: _put(qs[sid], exc)):
                for s in streams[sid]:
                    t0 = time.perf_counter()
                    self._probe("preprocess", tenant=sid)
                    validate_snapshot(s, self.feat_table.shape[0],
                                      tenant=sid)
                    ls = renumber_and_normalize(s)
                    dims = (ls.n_nodes, ls.src.shape[0], max_in_degree(ls))
                    if self.buckets is not None:
                        self._probe("bucket", tenant=sid)
                        choose_bucket(*dims, self.buckets)  # fail fast
                    else:
                        # fixed bucket known up front: pad here so the host
                        # prep fully overlaps device work (the bucketed
                        # case pads once the chunk's bucket is known)
                        ls = pad_snapshot(ls, self.feat_table, self.n_pad,
                                          self.e_pad, self.k_max)
                    pre_ms.append((time.perf_counter() - t0) * 1e3)
                    if not _put(qs[sid], (ls, dims)):
                        return
                _put(qs[sid], None)

        threads = [threading.Thread(target=producer, args=(sid,), daemon=True,
                                    name=f"dgnn-serve-producer-{sid}")
                   for sid in sids]
        for th in threads:
            th.start()
        return qs, pre_ms, stop, threads

    # ---------------------------------------------------- express lane ----

    def _spawn_express_producers(self, streams: dict, stop, pre_ms) -> tuple:
        """Producer threads for the stateless express tenants. Always
        fixed-bucket (the lane co-batches every slot into one shape, so
        padding happens host-side, fully overlapped). Items mirror the
        recurrent producers' ``(payload, dims)`` shape; ``stop`` is the
        shared shutdown event."""
        xp = self.express.plan
        sids = sorted(streams)
        qs = {sid: queue.Queue(maxsize=max(self.queue_depth,
                                           self.stream_chunk))
              for sid in sids}

        def _put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(sid):
            with _HandOff(lambda exc: _put(qs[sid], exc)):
                for s in streams[sid]:
                    t0 = time.perf_counter()
                    self._probe("preprocess", tenant=sid)
                    validate_snapshot(s, self._express_feat.shape[0],
                                      tenant=sid)
                    ls = renumber_and_normalize(s)
                    ps = pad_snapshot(ls, self._express_feat, xp.n_pad,
                                      xp.e_pad, xp.k_max)
                    pre_ms.append((time.perf_counter() - t0) * 1e3)
                    if not _put(qs[sid], (ps, None)):
                        return
                _put(qs[sid], None)

        threads = [threading.Thread(target=producer, args=(sid,), daemon=True,
                                    name=f"dgnn-serve-express-{sid}")
                   for sid in sids]
        for th in threads:
            th.start()
        return qs, threads

    def _run_express_group(self, params_x, group: list, outs: dict,
                           lat: list, ctr: dict,
                           sup: TenantSupervisor) -> None:
        """ONE express-lane launch: ``group`` is [(sid, [PaddedSnapshot,
        ...]), ...] — every snapshot of every member becomes an
        independent T=1 slot on the BATCH axis of a single static-family
        launch (B pow2-padded with dead length-0 slots). The tenants are
        stateless, so no checkpoint is taken and nothing is rolled back;
        failures follow the usual retry -> attribute -> quarantine path
        minus the state machinery and the degradation ladder."""
        members = [m for m in group if sup.ok(m[0])]
        attempt = 0
        while members:
            slots = [(sid, ps) for sid, chunk in members for ps in chunk]
            sids = sorted({sid for sid, _ in slots})
            b_real = len(slots)
            b_target = pow2_target(b_real)
            per_slot = [stack_time([ps]) for _, ps in slots]
            per_slot.extend([per_slot[0]] * (b_target - b_real))
            lengths = [1] * b_real + [0] * (b_target - b_real)
            key = ("express", b_target)
            warmed = key in self._warmed
            self._launch_ctx = tuple(sids)
            try:
                self._count_launch(ctr, self.express.model.stream_family)
                ctr["express"] = ctr.get("express", 0) + 1
                t0 = time.perf_counter()
                out_BT = self._express_step(params_x,
                                            stack_streams(per_slot), lengths)
                self._sync()
                dt_ms = (time.perf_counter() - t0) * 1e3
                self._warmed.add(key)
                timeout = self._policy.timeout_ms
                if timeout is not None and warmed and dt_ms > timeout:
                    raise LaunchTimeout(
                        f"express launch took {dt_ms:.1f}ms > "
                        f"launch_timeout_ms={timeout} (B={b_target}); "
                        "result discarded", site="launch")
                out_np = out_BT.cpu().numpy()
                now_ms = (time.perf_counter() - self._t0_run) * 1e3
                for b, (sid, _) in enumerate(slots):
                    outs[sid].append(out_np[b, 0])
                    self._commit_ms.setdefault(sid, []).append(now_ms)
                lat.extend([dt_ms / b_real] * b_real)
                ctr["live"] += b_real
                ctr["padded"] += b_target - b_real
                return
            except SUPERVISED as exc:
                err = self._attribution(exc)
                if isinstance(err, LaunchTimeout):
                    ctr["timeouts"] += 1
                attempt += 1
                if attempt <= self._policy.max_retries:
                    sup.note_retry(sids, attempt)
                    continue
                tenant = getattr(err, "tenant", None)
                if tenant is not None and tenant in sids:
                    sup.quarantine(tenant, err,
                                   site=getattr(err, "site", "launch"))
                    members = [m for m in members if m[0] != tenant]
                    attempt = 0
                    continue
                for sid in sids:
                    sup.quarantine(sid, err,
                                   site=getattr(err, "site", "launch"))
                return
            finally:
                self._launch_ctx = ()

    def _check_express_args(self, streams: dict, express_streams) -> list:
        """Validate the run_multi express arguments; returns the express
        sids (empty when the lane is unused)."""
        if not express_streams:
            return []
        if self.express is None:
            raise ValueError("express_streams= needs the express lane "
                             "configured: SnapshotServer(..., express="
                             "<static BoosterSession>)")
        clash = set(express_streams) & set(streams)
        if clash:
            raise ValueError(f"stream ids {sorted(map(repr, clash))} appear "
                             "in both streams and express_streams")
        return sorted(express_streams)

    def run_multi(self, params, states: dict, streams: dict, *,
                  express_streams: Optional[dict] = None,
                  express_params=None) -> tuple:
        """Serve many independent client streams concurrently.

        ``streams``: {stream_id: iterable of COOSnapshot}; ``states``:
        {stream_id: recurrent state} (one store per tenant — state is never
        shared across clients). Returns (states, {stream_id: [outputs]},
        ServeStats). Outputs per stream are in that stream's snapshot
        order, as host numpy arrays.

        ``plan.scheduler`` picks the device loop:

        ``"rounds"`` (default): rounds of up to ``stream_chunk`` snapshots
        a stream with a barrier between rounds; same-bucket chunks from
        different streams batch into one V3 launch.

        ``"continuous"``: iteration-level scheduling: no round barrier; a
        tick composes a fresh batch from whatever is READY, long backlogs
        are served in ``prefill_chunk``-bounded chunks interleaved with
        other tenants' steps, and per-tenant recurrent state lives in a
        paged pool (``state_pool_pages``) with LRU eviction to the host and
        recovery onto the card (serve/scheduler.ContinuousScheduler).
        Outputs and final states equal the round scheduler's bit for bit.

        Supervised per the plan's fault-isolation policy: with
        ``supervision="isolate"`` a failing tenant is quarantined — its
        error lands in ``stats.tenants[sid]``, its outputs stop at the
        last committed chunk — and the surviving tenants are unaffected;
        the strict default re-raises the first failure after a clean
        shutdown.

        EXPRESS LANE: with the server built over a second STATIC-family
        session (``SnapshotServer(..., express=<static BoosterSession>)``),
        ``express_streams`` ({sid: iterable of COOSnapshot}, disjoint from
        ``streams``) are served through it with ``express_params``. Each
        round co-batches ALL ready express snapshots into one launch with
        no checkpoint / rollback around it (each tick, under the continuous
        scheduler), counted in ``ServeStats.express_launches`` /
        ``launches_by_family``. Express outputs land in the same outputs
        dict, in stream order.
        """
        x_sids = self._check_express_args(streams, express_streams)
        if self.plan.scheduler == "continuous":
            from repro_torch.serve.scheduler import ContinuousScheduler

            return ContinuousScheduler(self).run(
                params, states, streams, express_streams=express_streams,
                express_params=express_params)
        return self._run_multi_rounds(params, states, streams,
                                      express_streams if x_sids else None,
                                      express_params)

    def _run_multi_rounds(self, params, states: dict, streams: dict,
                          express_streams: Optional[dict] = None,
                          express_params=None) -> tuple:
        """The round-based multi-tenant device loop (plan.scheduler ==
        "rounds"); see ``run_multi``."""
        sids = sorted(streams)
        x_sids = sorted(express_streams or {})
        t_start = time.perf_counter()
        self._t0_run, self._commit_ms = t_start, {}
        qs, pre_ms, stop, threads = self._spawn_producers(streams)
        xqs: dict = {}
        if x_sids:
            xqs, x_threads = self._spawn_express_producers(
                express_streams, stop, pre_ms)
            threads = threads + x_threads
        outs: dict = {sid: [] for sid in sids + x_sids}
        lat: list = []
        ctr = {"live": 0, "padded": 0, "promoted": 0, "launches": 0,
               "timeouts": 0, "degraded": 0}
        sup = self._supervisor(sids + x_sids, outs)
        active = set(sids)
        x_active = set(x_sids)
        batched = self._use_stream()
        try:
            with self._fault_window():
                while active or x_active:
                    # express round: every express tenant's next chunk of
                    # T=1 slots, co-batched into ONE stateless launch
                    x_group: list = []
                    for sid in sorted(x_active):
                        chunk = []
                        while len(chunk) < self.stream_chunk:
                            item = xqs[sid].get()
                            if item is None:
                                x_active.discard(sid)
                                break
                            if isinstance(item, BaseException):
                                x_active.discard(sid)
                                chunk = []
                                _producer_error(sup, sid, item)
                                break
                            chunk.append(item[0])
                        if chunk:
                            x_group.append((sid, chunk))
                    if x_group:
                        self._run_express_group(express_params, x_group,
                                                outs, lat, ctr, sup)
                        x_active -= set(sup.quarantined)
                    if not active:
                        continue
                    # one round: pull the next chunk of every active stream
                    chunks = {}
                    for sid in sorted(active):
                        chunk: list = []
                        dims: list = []
                        while len(chunk) < self.stream_chunk:
                            item = qs[sid].get()
                            if item is None:
                                active.discard(sid)
                                break
                            if isinstance(item, BaseException):
                                # producer-side failure (validation, no-fit
                                # bucket, injected fault): strict raises;
                                # isolate quarantines THIS tenant — outputs
                                # stop at the last committed chunk, the
                                # round continues without it
                                active.discard(sid)
                                chunk = []
                                _producer_error(sup, sid, item)
                                break
                            chunk.append(item[0])
                            dims.append(item[1])
                            if not batched and chunk:
                                break  # per-step levels: no chunking
                        if chunk:
                            chunks[sid] = (chunk, dims)
                    if not chunks:
                        continue
                    if not batched:
                        # per-step levels: round-robin per-snapshot
                        # stepping, checkpointed per snapshot
                        for sid, (chunk, dims) in sorted(chunks.items()):
                            if not sup.ok(sid):
                                continue
                            ckpt = sup.checkpoint(states, [sid])
                            try:
                                for ls, d in zip(chunk, dims):
                                    ps = (ls if isinstance(ls, PaddedSnapshot)
                                          else pad_snapshot(
                                              ls, self.feat_table,
                                              *self._chunk_bucket([d])))
                                    ckpt = sup.checkpoint(states, [sid])
                                    t0 = time.perf_counter()
                                    states[sid], out = self._step(
                                        params, states[sid], ps)
                                    self._sync()
                                    lat.append(
                                        (time.perf_counter() - t0) * 1e3)
                                    outs[sid].append(out.cpu().numpy())
                            except SUPERVISED as exc:
                                sup.rollback(states, ckpt)
                                sup.quarantine(sid, self._attribution(exc))
                                active.discard(sid)
                        continue
                    # group same-bucket chunks across streams -> one
                    # supervised launch each
                    groups: dict = {}
                    for sid, (chunk, dims) in sorted(chunks.items()):
                        bucket = self._chunk_bucket(dims)
                        groups.setdefault(bucket, []).append(
                            (sid, chunk, bucket))
                    if (self.promote_buckets is not None
                            and self.buckets is not None):
                        # cross-bucket batching: promote smaller-bucket
                        # chunks into the next-larger in-flight bucket
                        # (guarded by the per-bucket cost ratio — measured
                        # step times under the adaptive guard, else the
                        # static padded-compute proxy)
                        before = {b: len(m) for b, m in groups.items()}
                        groups = promote_bucket_groups(
                            groups, self.buckets, self.promote_buckets,
                            cost=self._promotion_cost(params))
                        ctr["promoted"] += sum(
                            len(m) - before.get(b, 0)
                            for b, m in groups.items())
                    for bucket in sorted(groups):
                        self._run_group_supervised(params, states,
                                                   groups[bucket], outs,
                                                   lat, ctr, sup)
                    # tenants quarantined by the launch path stop being
                    # scheduled (their producers are drained at shutdown)
                    active -= set(sup.quarantined)
        finally:
            self._shutdown(stop, list(qs.values()) + list(xqs.values()),
                           threads)
        total = (time.perf_counter() - t_start) * 1e3
        return states, outs, self._make_stats(lat, pre_ms, total, ctr, sup)
