"""Typed plan/execute front-end of the port.

The same surface as the JAX package's ``repro.api``: callers build one
frozen, validated :class:`StreamPlan` with :func:`plan` and hand it to a
:class:`BoosterSession` (``run`` one stream, ``run_batched`` B ragged
streams in one launch, ``serve`` / ``serve_multi`` raw COO snapshot
iterators through the serve engine, serve/engine.py) or to
:func:`run_arrays` (pre-padded ELL arrays). ``plan()`` accepts and
validates every field the JAX one does, with the same messages. Every
level of ``FAMILY_LEVELS`` runs for every family: gcrn, evolve and stacked
on padded snapshot streams, tgn on padded event batches (graph/events.py),
static_gcn on independent snapshots; the stateful families at v3 also with
``state_residency="hbm_paged"`` (their paged engines). The serve-policy
fields steer the serve engine and are ignored by ``run`` /
``run_batched`` / ``run_arrays``, as in the JAX package; the continuous
scheduler's (``scheduler="continuous"``, ``state_pool_pages``,
``prefill_chunk``) steer ``serve_multi`` and are ignored by the
single-stream ``serve`` too. A sharded ``DeviceSpec`` (launch/mesh.py)
splits ``run_batched`` / ``run_arrays``'s batched launch over that many
cards (CPU slices on the CPU), bit for bit the unsharded launch; ``plan()``
refuses one wider than the host's cards, and the serve engine refuses to
serve a sharded plan, as the JAX package's do.

The torch device is an argument of the session (and of ``run_arrays``),
not a plan field. It defaults to "cuda" and raises when there is no card;
``device="cpu"`` runs the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core.dataflow import (build_model, init_states_batched,
                                       run_plan, run_plan_batched)
from repro_torch.graph.padding import host_copy, stack_ragged
from repro_torch.kernels import engine as _engine
from repro_torch.kernels import ops as _ops
from repro_torch.launch.mesh import DeviceSpec

# dataflow levels each family supports (the paper's ablation ladder); the
# JAX package's table, so plans validate identically
FAMILY_LEVELS = {
    "gcrn": ("baseline", "o1", "v2", "v3"),
    "stacked": ("baseline", "o1", "v1", "v2", "v3"),
    "evolve": ("baseline", "o1", "v1", "v3"),
    "tgn": ("baseline", "v3"),
    "static_gcn": ("baseline", "v3"),
}

_FAMILY_OF_TYPE = {
    "integrated": "gcrn",
    "stacked": "stacked",
    "weights_evolved": "evolve",
    "event_memory": "tgn",
    "static": "static_gcn",
}

# alignment the tn / td knobs are validated against: the CUDA kernels'
# register micro-tile of ROW_ALIGN rows. The kernels take any node count and
# pad widths to the micro-tile themselves, so tn and td do not change what
# they compute; the plan keeps both knobs so it validates as the JAX one does
_TILE_ALIGN = _engine.ROW_ALIGN

_UNSET = object()


def family_for(cfg: DGNNConfig) -> str:
    """Stream-engine family (registry key) of a DGNN model config."""
    try:
        return _FAMILY_OF_TYPE[cfg.dgnn_type]
    except KeyError:
        raise ValueError(f"unknown dgnn_type {cfg.dgnn_type!r}") from None


@dataclass(frozen=True)
class StreamPlan:
    """A validated, immutable execution plan (see ``repro.api.StreamPlan``
    for what every field means)."""

    family: str
    level: str = "v3"
    temporal: Optional[str] = None
    tn: int = 128
    td: Optional[int] = None
    state_residency: str = "vmem"
    buffer_depth: Optional[int] = None
    batch: int = 1
    lengths: Optional[tuple] = None
    device: DeviceSpec = field(default_factory=DeviceSpec)
    # serve policy (SnapshotServer consumes these)
    n_pad: int = 640
    e_pad: int = 4096
    k_max: int = 64
    buckets: Optional[tuple] = None   # ((n, e, k), ...) smallest-first
    stream_chunk: int = 8             # snapshots per v3 chunk launch
    queue_depth: int = 2              # host->device queue (ping-pong = 2)
    promote_buckets: Optional[float] = None  # max promotion overhead ratio
    promotion_guard: str = "static"   # "static" proxy | "measured" times
    # multi-tenant scheduling (serve/scheduler.py)
    scheduler: str = "rounds"
    state_pool_pages: Optional[int] = None
    prefill_chunk: Optional[int] = None
    # fault isolation / recovery (serve/supervision.py)
    supervision: str = "strict"       # "strict" raise | "isolate" per tenant
    max_retries: int = 0              # chunk-launch retries (rolled back)
    retry_backoff_ms: float = 10.0    # exponential backoff base
    launch_timeout_ms: Optional[float] = None  # per-launch deadline
    degrade: bool = False             # solo / oracle degradation ladder
    fault_plan: Optional[object] = None  # serve.faults.FaultPlan (chaos)

    def __post_init__(self):
        _validate(self)


def _validate(p: StreamPlan) -> None:
    fams = _ops.stream_families()
    if p.family not in fams:
        raise ValueError(f"unknown stream-engine family {p.family!r}; "
                         f"registered: {fams}")
    if p.level not in FAMILY_LEVELS[p.family]:
        raise ValueError(
            f"dataflow level {p.level!r} is not defined for family "
            f"{p.family!r}; supported: {FAMILY_LEVELS[p.family]}")
    temporal = _ops.family_temporal(p.family)
    if p.temporal is None:
        object.__setattr__(p, "temporal", temporal)  # frozen: fill-in
    elif p.temporal != temporal:
        raise ValueError(
            f"temporal={p.temporal!r} contradicts family {p.family!r}, "
            f"whose cell spec declares {temporal!r} time semantics")
    if p.temporal == "static" and p.state_pool_pages is not None:
        raise ValueError(
            "state_pool_pages pages RECURRENT tenant state; family "
            f"{p.family!r} is static (stateless) — nothing to page")
    if not (isinstance(p.tn, int) and p.tn > 0 and p.tn % _TILE_ALIGN == 0):
        raise ValueError(f"tn={p.tn!r}: node tile must be a positive "
                         f"multiple of {_TILE_ALIGN}")
    if p.td is not None and not (isinstance(p.td, int) and p.td > 0
                                 and p.td % _TILE_ALIGN == 0):
        raise ValueError(f"td={p.td!r}: state-feature block must be None "
                         f"(fully resident) or a positive multiple of "
                         f"{_TILE_ALIGN}")
    if p.state_residency not in _ops.RESIDENCY_MODES:
        raise ValueError(
            f"state_residency={p.state_residency!r}: expected one of "
            f"{_ops.RESIDENCY_MODES}")
    if p.state_residency == "hbm_paged":
        if p.temporal == "static":
            raise ValueError(
                "state_residency='hbm_paged' is undefined for static "
                f"family {p.family!r}: zero StateDefs — there is no "
                "recurrent store to page")
        if p.level != "v3":
            raise ValueError(
                "state_residency='hbm_paged' is a stream-engine (v3) "
                f"capability; level={p.level!r} has no resident store")
        if p.td is None:
            raise ValueError(
                "state_residency='hbm_paged' requires td blocking: td is "
                "the (n_global, td) paging window the DMA ring stages "
                "(td=None keeps the store fully VMEM-resident)")
    if p.buffer_depth is not None:
        if p.state_residency != "hbm_paged":
            raise ValueError(
                f"buffer_depth={p.buffer_depth!r} requires "
                "state_residency='hbm_paged': the DMA staging ring only "
                "exists for an HBM-paged store")
        if p.buffer_depth not in _ops.BUFFER_DEPTHS:
            raise ValueError(
                f"buffer_depth must be one of {_ops.BUFFER_DEPTHS}, "
                f"got {p.buffer_depth!r}")
    if not (isinstance(p.batch, int) and p.batch >= 1):
        raise ValueError(f"batch={p.batch!r}: need an int >= 1")
    if p.lengths is not None:
        if p.level != "v3":
            raise ValueError("ragged lengths are a stream-engine (v3) "
                             f"capability; level={p.level!r}")
        if len(p.lengths) != p.batch:
            raise ValueError(f"lengths has {len(p.lengths)} entries for "
                             f"batch={p.batch}")
        if not all(isinstance(t, (int, np.integer)) and t >= 0
                   for t in p.lengths):
            raise ValueError(f"lengths={p.lengths!r}: need ints >= 0")
        if max(p.lengths) == 0:
            raise ValueError("lengths are all zero: nothing to run")
    if not isinstance(p.device, DeviceSpec) or p.device.n_devices < 1:
        raise ValueError(f"device={p.device!r}: need a DeviceSpec with "
                         "n_devices >= 1")
    if p.device.n_devices > 1:
        if p.level != "v3":
            raise ValueError("DeviceSpec sharding shards the stream-engine "
                             f"batch grid axis; level={p.level!r} has none")
        if p.batch % p.device.n_devices:
            raise ValueError(f"batch={p.batch} is not divisible by "
                             f"n_devices={p.device.n_devices}")
        if p.device.n_devices > torch.cuda.device_count():
            raise ValueError(
                f"DeviceSpec wants {p.device.n_devices} devices; this host "
                f"has {torch.cuda.device_count()}")
    for name in ("n_pad", "e_pad", "k_max", "stream_chunk", "queue_depth"):
        v = getattr(p, name)
        if not (isinstance(v, int) and v >= 1):
            raise ValueError(f"{name}={v!r}: need an int >= 1")
    if p.buckets is not None:
        bs = tuple(tuple(b) for b in p.buckets)
        if not bs or any(len(b) != 3 or any(int(x) < 1 for x in b)
                         for b in bs):
            raise ValueError(f"buckets={p.buckets!r}: need non-empty "
                             "(n_pad, e_pad, k_max) triples")
        for a, b in zip(bs, bs[1:]):
            if any(x > y for x, y in zip(a, b)):
                raise ValueError(f"buckets must be a smallest-first chain; "
                                 f"{a} !<= {b}")
    if p.promote_buckets is not None:
        if p.buckets is None:
            raise ValueError("promote_buckets needs bucketed padding "
                             "(buckets=None)")
        if not p.promote_buckets > 0:
            raise ValueError(f"promote_buckets={p.promote_buckets!r}: need "
                             "a ratio > 0")
    if p.promotion_guard not in ("static", "measured"):
        raise ValueError(f"promotion_guard={p.promotion_guard!r}: "
                         "'static' or 'measured'")
    if p.promotion_guard == "measured" and p.promote_buckets is None:
        raise ValueError("promotion_guard='measured' without "
                         "promote_buckets: nothing to guard")
    if p.scheduler not in ("rounds", "continuous"):
        raise ValueError(f"scheduler={p.scheduler!r}: 'rounds' or "
                         "'continuous'")
    if p.scheduler == "continuous" and p.level != "v3":
        raise ValueError("the continuous-batching scheduler composes "
                         "ragged stream-engine launches; "
                         f"level={p.level!r} has no stream kernel")
    if p.state_pool_pages is not None:
        if p.scheduler != "continuous":
            raise ValueError("state_pool_pages is a continuous-scheduler "
                             "capability (scheduler='continuous')")
        if not (isinstance(p.state_pool_pages, int)
                and p.state_pool_pages >= 1):
            raise ValueError(f"state_pool_pages={p.state_pool_pages!r}: "
                             "need an int >= 1 (None = unbounded)")
    if p.prefill_chunk is not None:
        if p.scheduler != "continuous":
            raise ValueError("prefill_chunk is a continuous-scheduler "
                             "capability (scheduler='continuous')")
        if not (isinstance(p.prefill_chunk, int)
                and 1 <= p.prefill_chunk <= p.stream_chunk):
            raise ValueError(
                f"prefill_chunk={p.prefill_chunk!r}: need an int in "
                f"[1, stream_chunk={p.stream_chunk}] (a prefill chunk "
                "larger than the launch chunk cap cannot be composed)")
    if p.supervision not in ("strict", "isolate"):
        raise ValueError(f"supervision={p.supervision!r}: 'strict' or "
                         "'isolate'")
    if not (isinstance(p.max_retries, int) and p.max_retries >= 0):
        raise ValueError(f"max_retries={p.max_retries!r}: need an int >= 0")
    if not (isinstance(p.retry_backoff_ms, (int, float))
            and p.retry_backoff_ms >= 0):
        raise ValueError(f"retry_backoff_ms={p.retry_backoff_ms!r}: "
                         "need >= 0")
    if p.launch_timeout_ms is not None and not p.launch_timeout_ms > 0:
        raise ValueError(f"launch_timeout_ms={p.launch_timeout_ms!r}: "
                         "need > 0 (None = no deadline)")
    if not isinstance(p.degrade, bool):
        raise ValueError(f"degrade={p.degrade!r}: need a bool")
    if p.fault_plan is not None:
        from repro_torch.serve.faults import FaultPlan

        if not isinstance(p.fault_plan, FaultPlan):
            raise ValueError(f"fault_plan={p.fault_plan!r}: need a "
                             "serve.faults.FaultPlan")


def plan(cfg: Optional[DGNNConfig] = None, *, family: Optional[str] = None,
         temporal: Optional[str] = None,
         level: Optional[str] = None, tn: int = 128, td=_UNSET,
         state_residency: str = "vmem", buffer_depth=None,
         batch: int = 1, lengths=None, device: Optional[DeviceSpec] = None,
         n_pad: int = 640, e_pad: int = 4096, k_max: int = 64,
         buckets=None, stream_chunk: int = 8, queue_depth: int = 2,
         promote_buckets=None, promotion_guard: str = "static",
         scheduler: str = "rounds", state_pool_pages=None,
         prefill_chunk=None,
         supervision: str = "strict", max_retries: int = 0,
         retry_backoff_ms: float = 10.0, launch_timeout_ms=None,
         degrade: bool = False, fault_plan=None) -> StreamPlan:
    """Build a validated :class:`StreamPlan`. From a ``DGNNConfig`` the
    family, the preferred level and ``td`` default from the config; from a
    bare ``family`` the level defaults to "v3"."""
    if cfg is not None:
        fam = family_for(cfg)
        if family is not None and family != fam:
            raise ValueError(f"family={family!r} contradicts cfg "
                             f"{cfg.name!r} (family {fam!r})")
        family = fam
        level = level if level is not None else cfg.dataflow
        td = cfg.stream_td if td is _UNSET else td
    if family is None:
        raise ValueError("plan() needs a DGNNConfig or a family name")
    return StreamPlan(
        family=family, temporal=temporal,
        level=level if level is not None else "v3", tn=tn,
        td=None if td is _UNSET else td,
        state_residency=state_residency, buffer_depth=buffer_depth,
        batch=batch,
        lengths=None if lengths is None else tuple(int(t) for t in lengths),
        device=device if device is not None else DeviceSpec(),
        n_pad=n_pad, e_pad=e_pad, k_max=k_max,
        buckets=None if buckets is None else tuple(tuple(b) for b in buckets),
        stream_chunk=stream_chunk, queue_depth=queue_depth,
        promote_buckets=promote_buckets, promotion_guard=promotion_guard,
        scheduler=scheduler, state_pool_pages=state_pool_pages,
        prefill_chunk=prefill_chunk,
        supervision=supervision, max_retries=max_retries,
        retry_backoff_ms=retry_backoff_ms,
        launch_timeout_ms=launch_timeout_ms, degrade=degrade,
        fault_plan=fault_plan)


def run_arrays(p: StreamPlan, *args, force_ref: bool = False,
               device="cuda"):
    """Pre-padded ELL stream arrays straight through the stream engine
    (the argument lists of ``kernels/ops.stream_steps``), whatever the
    plan's level, as in the JAX package. A plan with ``batch > 1`` or
    ragged ``lengths`` takes the batched entry."""
    if p.batch > 1 or p.lengths is not None:
        return _ops.stream_steps_batched(
            p.family, *args, tn=p.tn, td=p.td, lengths=p.lengths,
            state_residency=p.state_residency, buffer_depth=p.buffer_depth,
            force_ref=force_ref, device=device, device_spec=p.device)
    return _ops.stream_steps(p.family, *args, tn=p.tn, td=p.td,
                             state_residency=p.state_residency,
                             buffer_depth=p.buffer_depth,
                             force_ref=force_ref, device=device)


class BoosterSession:
    """A model + params + recurrent state bound to one :class:`StreamPlan`
    and one torch device.

    ``run`` advances the session's own state; ``run_batched`` is stateless
    by default (pass ``states`` to continue earlier chunks); ``serve`` /
    ``serve_multi`` run raw COO snapshot iterators through the serve
    engine, which needs the global node-feature table (``feat_table``).
    """

    def __init__(self, cfg: DGNNConfig, plan: Optional[StreamPlan] = None,
                 *, n_global: int = 4096, feat_table=None, params=None,
                 gen=None, device="cuda", force_ref: bool = False):
        self.device = _ops.resolve_device(device)
        self.cfg = cfg
        self.plan = plan if plan is not None else _plan_builder(cfg)
        fam = family_for(cfg)
        if self.plan.family != fam:
            raise ValueError(f"plan family {self.plan.family!r} does not "
                             f"serve cfg {cfg.name!r} (family {fam!r})")
        self.model = build_model(cfg, n_global=n_global)
        self.n_global = n_global
        self.feat_table = feat_table
        self.force_ref = force_ref
        self.params = None
        self.state = None
        if params is not None:
            self.params = _ops.to_device(params, self.device)
            self.reset_state()
        elif gen is not None:
            self.init(gen)

    def init(self, gen: torch.Generator):
        """(Re)initialise params from ``gen`` and a fresh state."""
        self.params = _ops.to_device(self.model.init(gen), self.device)
        self.reset_state()
        return self.params, self.state

    def reset_state(self):
        self.state = self.model.init_state(self.params, mode=self.plan.level)
        return self.state

    def _need_params(self):
        if self.params is None:
            raise RuntimeError("session has no params: pass params= or "
                               "gen=, or call session.init(gen)")

    def run(self, snaps_T):
        """One padded (T, ...) snapshot stream (event-batch stream for tgn)
        through the plan's engine, advancing the session state. Returns
        (T, n_pad, out) outputs."""
        self._need_params()
        with _obs.span("session.run"):
            with _obs.sync(self.device if host_copy(snaps_T, self.device)
                           else None, "upload"):
                snaps_T = snaps_T.to(self.device)
            self.state, outs = run_plan(self.model, self.params, self.state,
                                        snaps_T, self.plan,
                                        force_ref=self.force_ref)
        return outs

    def run_batched(self, streams: list, states=None):
        """B independent padded (T_b, ...) streams (snapshots, or event
        batches for tgn), ragged T welcome, in one launch. Shorter streams are stacked to the longest (the tail
        repeats the last snapshot and is masked out in the launch).
        Returns ``(final_states, [outs_b (T_b, n, out)])``."""
        self._need_params()
        with _obs.span("session.run_batched"):
            B = len(streams)
            snaps_BT, lens = stack_ragged(streams, self.device)
            if (self.plan.lengths is not None
                    and list(self.plan.lengths) != lens):
                raise ValueError(f"plan.lengths={self.plan.lengths} does "
                                 f"not match stream lengths {lens}")
            p = self.plan
            if p.batch != B:
                p = dataclasses.replace(p, batch=B, lengths=None)
            if len(set(lens)) > 1 and p.lengths is None:
                p = dataclasses.replace(p, lengths=tuple(lens))
            if states is None:
                states = init_states_batched(self.model, self.params, B,
                                             mode=p.level)
            states, outs_BT = run_plan_batched(self.model, self.params,
                                               states, snaps_BT, p,
                                               force_ref=self.force_ref)
            with _obs.span("split"):
                return states, [outs_BT[b, :lens[b]] for b in range(B)]

    # ------------------------------------------------------ serving ----

    def _server(self):
        from repro_torch.serve.engine import SnapshotServer

        if self.feat_table is None:
            raise RuntimeError("serving needs the global feat_table: pass "
                               "feat_table= to BoosterSession")
        return SnapshotServer(session=self)

    def serve(self, snaps: Iterable):
        """Serve a raw COO snapshot iterator through the engine (host
        preprocessing overlapped with device launches), advancing the
        session state. Returns ``(outputs, ServeStats)``; the outputs are
        host numpy arrays, one a snapshot."""
        self._need_params()
        if self.state is None:
            self.reset_state()
        self.state, outs, stats = self._server().run(self.params, self.state,
                                                     snaps)
        return outs, stats

    def serve_multi(self, streams: dict, states: Optional[dict] = None):
        """Serve many independent client streams concurrently (one
        recurrent state per tenant; same-bucket chunks co-batched into one
        launch). Returns ``(states, {sid: [outputs]}, ServeStats)``."""
        self._need_params()
        if states is None:
            states = {sid: self.model.init_state(self.params,
                                                 mode=self.plan.level)
                      for sid in streams}
        return self._server().run_multi(self.params, states, streams)


_plan_builder = plan
