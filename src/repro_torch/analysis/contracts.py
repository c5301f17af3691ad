"""Kernel-contract passes of the port: static checks of the CUDA stream
engines' launches, and a replay of their rings' protocol.

Every ``(family, residency, buffer_depth, td)`` point of the JAX sweep
(``registry_points``) goes through ``ops.stream_steps(..., device="cpu")``
with ``engine.recording_launches`` on, so the padding and packing of
kernels/ops.py run and each engine launcher assembles its launch (checks,
outputs, scratch, the C arguments) and records it instead of launching.
Checked per point:

  * the point assembles and records exactly its kernel
    (``launch-assembly-error``);
  * ``engine.smem_bytes`` at the dims read back from the recorded
    arguments equals the figure the wrapper budget-checked, and the
    recorded cluster launch equals ``engine.engine_cluster_config``; on the
    card also the library's own ``<name>_smem_bytes``, cluster launch and
    static plan; and the resident EvolveGCN's widest D is the widest that
    fits (``vmem-bytes-drift``);
  * each state store the kernel evolves in place is the very tensor the
    wrapper returns (``hbm-alias-coverage``);
  * the static family takes and returns no state (``static-zero-states``);
  * the protocol log of the paged state ring and EvolveGCN's GRU slab ring
    replays clean (``dma-ring-order``, ``dma-unpaired-start``,
    ``dma-missing-site``), and EvolveGCN's W planes alternate as the steps
    need (``pingpong-parity``). On the CPU the log replayed is the launch's
    plain version (``engine.protocol_plain``: what the kernel's issue
    schedule writes for this launch's data); on the card, the log the
    kernel writes (the wrapper's ``proto=True``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import cases
from repro_torch.analysis.core import Finding, Rule
from repro_torch.kernels import engine, ops

ENGINE_PATH = "src/repro_torch/kernels/engine.py"

RULES = {r.id: r for r in (
    Rule("dma-unpaired-start", "contracts", "error",
         "Every ring issue (TMA boxes or bulk copies completing on a slot's "
         "mbarrier) must be waited before the launch ends, and every wait "
         "must follow an issue of its slot: a copy left in flight lands in "
         "a slot the next sweep reuses."),
    Rule("dma-ring-order", "contracts", "error",
         "A ring's window s lands in slot s % depth with parity (s / depth) "
         "& 1, windows are issued and waited in order, every window of each "
         "live tile's sweep exactly once, and no slot is reissued before "
         "its previous phase was waited — else a window is read before it "
         "lands or overwritten while it is read."),
    Rule("dma-missing-site", "contracts", "error",
         "Every CTA issues the sweeps its live tiles need; a resident "
         "launch has no paged ring and logs none; a log that overflowed "
         "lost rows, and nothing in it can be vouched for."),
    Rule("hbm-alias-coverage", "contracts", "error",
         "A stream engine evolves its state stores in place: the final "
         "state the wrapper returns must be the very store tensor the "
         "kernel wrote — a copy returns stale state, and a store written "
         "but not returned is lost."),
    Rule("pingpong-parity", "contracts", "error",
         "EvolveGCN's resident W planes: step t reads the plane step t-1 "
         "wrote, starting at plane 0, a live step writes the other plane, "
         "and the W returned is the plane written last (paged: one plane, "
         "its pages, updated in place); the other families hold no planes."),
    Rule("vmem-bytes-drift", "contracts", "error",
         "The wrappers refuse a launch by engine.smem_bytes: the estimate "
         "must equal the figure each wrapper checked and each library's "
         "own <name>_smem_bytes (with its cluster launch), or the budget "
         "check passes launches the card refuses, or refuses good ones."),
    Rule("static-zero-states", "contracts", "error",
         "The 'static' temporal contract is zero recurrent state: the "
         "static engine takes no state store and returns only its outputs."),
    Rule("launch-assembly-error", "contracts", "error",
         "A sweep point that fails to assemble (or has no fixture, or "
         "records another kernel's launch) cannot be verified — the point "
         "itself is the finding."),
)}

#: the errors a launch's assembly raises (checks, refusals, a missing
#: fixture or family); anything else is a bug in the analyzer and raises
ASSEMBLY_ERRORS = (ValueError, RuntimeError, KeyError, TypeError,
                   NotImplementedError)

#: each family's resident engine (its paged one adds ``_paged``)
ENGINE = {"gcrn": "gcrn_engine", "evolve": "evolve_engine",
          "stacked": "stacked_engine", "tgn": "tgn_engine",
          "static_gcn": "static_engine"}

#: the argument names of a state store (the static engine's ``w`` is its
#: shared weights, not a state)
_STATE_NAMES = frozenset({"h_store", "c_store", "store"})


@dataclass(frozen=True)
class Point:
    """One contract-sweep coordinate."""

    family: str
    residency: str
    depth: Optional[int]
    td: Optional[int]

    def label(self) -> str:
        tag = f"{self.family}/{self.residency}/td={self.td}"
        return tag if self.depth is None else f"{tag}/depth={self.depth}"

    def kernel(self) -> str:
        base = ENGINE.get(self.family, self.family)
        return base + ("_paged" if self.residency == "hbm_paged" else "")


def registry_points(families=None) -> list:
    """The JAX sweep's points: both resident blockings for every family,
    every ring depth under hbm_paged for the stateful ones."""
    families = ops.stream_families() if families is None else families
    pts = []
    for family in sorted(families):
        pts.append(Point(family, "vmem", None, None))
        pts.append(Point(family, "vmem", None, cases.TD))
        if ops.family_temporal(family) != "static":
            for depth in ops.BUFFER_DEPTHS:
                pts.append(Point(family, "hbm_paged", depth, cases.TD))
    return pts


def record_point(point: Point) -> list:
    """The launches one point assembles through ``ops.stream_steps`` on the
    CPU, recorded, not run."""
    args = cases.stream_args(point.family)
    kw = dict(tn=cases.TN, td=point.td, device="cpu")
    if point.residency == "hbm_paged":
        kw.update(state_residency="hbm_paged", buffer_depth=point.depth)
    with engine.recording_launches() as recorded:
        ops.stream_steps(point.family, *args, **kw)
    return list(recorded)


def _find(rule: str, msg: str, path: str = ENGINE_PATH) -> Finding:
    r = RULES[rule]
    return Finding(rule, r.group, r.severity, path, 0, msg)


# ------------------------------------------------------ launch checks --

def launch_dims(rec) -> dict:
    """The ``smem_bytes`` arguments of a recorded launch, read back from its
    C arguments' shapes and ints (not from the fixture, nor from the dims
    the wrapper recorded)."""
    a, i = rec.args, rec.ints
    ring = {key: i[key] for key in ("td", "depth") if key in i}
    family = rec.name.split("_")[0]
    if family == "gcrn":
        dims = dict(k=a["idx"].shape[-1], din=a["x"].shape[-1],
                    H=a["h_store"].shape[-1], n=a["idx"].shape[2])
    elif family == "stacked":
        dims = dict(k=a["idx"].shape[-1], din=a["x"].shape[-1],
                    dmid=a["wg"].shape[-1], H=a["h_store"].shape[-1])
    elif family == "tgn":
        dims = dict(k=a["lid"].shape[-1], din=a["x"].shape[-1],
                    H=a["store"].shape[-1])
        if ring:
            dims["n"] = a["lid"].shape[2]
    elif family == "evolve":
        dims = dict(k=a["idx"].shape[-1], D=a["w"].shape[2])
        if not ring:
            dims["L"] = a["w"].shape[1]
    else:
        dims = dict(k=a["idx"].shape[-1], D=a["w"].shape[-1])
    return {**dims, **ring}


def _same_tensor(a, b) -> bool:
    return (torch.is_tensor(a) and torch.is_tensor(b)
            and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr()
            and a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def check_aliases(label: str, rec) -> list:
    """The stores the kernel evolves in place are what the wrapper
    returns: each store argument is its result's tensor, and no state
    result lacks a store."""
    out = []
    stores = engine.STORE_ARGS[rec.name.split("_")[0]]
    for arg, i in stores.items():
        t = rec.args.get(arg)
        got = rec.result[i] if i < len(rec.result) else None
        if t is None:
            out.append(_find("hbm-alias-coverage",
                             f"{label}: {rec.name} returns state {i} but "
                             f"takes no store argument {arg!r}"))
        elif not any(_same_tensor(t, r) for r in rec.result):
            out.append(_find("hbm-alias-coverage",
                             f"{label}: {rec.name} writes store {arg!r} in "
                             "place but returns no view of it — the "
                             "evolved state is lost"))
        elif not _same_tensor(t, got):
            out.append(_find("hbm-alias-coverage",
                             f"{label}: {rec.name} returns a copy in place "
                             f"of store {arg!r} (result {i}) — the state "
                             "returned is not the one the kernel evolved"))
    for i in range(1, len(rec.result)):
        if i not in stores.values():
            out.append(_find("hbm-alias-coverage",
                             f"{label}: {rec.name} returns state {i} that no "
                             "store argument holds"))
    return out


def check_static(label: str, rec) -> list:
    """A static launch carries no state: one result (its outputs, the
    ``out`` argument), no store argument, and its family's temporal
    contract is "static"."""
    out = []
    family = "static_gcn"
    if ops.family_temporal(family) != "static":
        out.append(_find("static-zero-states",
                         f"{label}: family {family!r} is declared "
                         f"{ops.family_temporal(family)!r}, not 'static'"))
    states = sorted(_STATE_NAMES & set(rec.args))
    if (states or engine.STORE_ARGS["static"] or len(rec.result) != 1
            or not _same_tensor(rec.result[0], rec.args.get("out"))):
        out.append(_find("static-zero-states",
                         f"{label}: static launch carries state: store "
                         f"arguments {states}, {len(rec.result)} result(s)"
                         " — the static contract is zero recurrent state"))
    return out


def _cluster_of(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k != "max_active_clusters"}


def check_smem(label: str, rec, device: str = "cpu") -> list:
    """``engine.smem_bytes`` at the dims read back from the launch against
    the figure its wrapper checked and its cluster launch; on the card
    against the library's own."""
    out = []
    dims = launch_dims(rec)
    est = engine.smem_bytes(rec.name, **dims)
    if est != rec.smem:
        out.append(_find("vmem-bytes-drift",
                         f"{label}: smem_bytes({rec.name}, {dims}) = {est} B "
                         f"but the wrapper budget-checked {rec.smem} B"))
    B = rec.ints["B"]
    if rec.cluster is not None:
        want = engine.engine_cluster_config(rec.name, B, **dims)
        if want != rec.cluster:
            out.append(_find("vmem-bytes-drift",
                             f"{label}: recorded cluster launch "
                             f"{rec.cluster} != engine_cluster_config {want}"))
    if device != "cuda":
        return out
    lib = engine.library_smem_bytes(rec.name, **dims)
    if lib != est:
        out.append(_find("vmem-bytes-drift",
                         f"{label}: smem_bytes({rec.name}, {dims}) = {est} B "
                         f"but the library's own figure is {lib} B"))
    if rec.cluster is not None:
        got = _cluster_of(engine.library_engine_cluster_config(
            rec.name, B, **dims))
        want = engine.engine_cluster_config(rec.name, B, **dims)
        if got != want:
            out.append(_find("vmem-bytes-drift",
                             f"{label}: the library's cluster launch {got} != "
                             f"engine_cluster_config {want}"))
    else:
        got = engine.library_static_plan(B, dims["k"], dims["D"])
        want = engine.static_plan(B, dims["k"], dims["D"],
                                  rec.args["widths"])
        if got != {key: want[key] for key in got}:
            out.append(_find("vmem-bytes-drift",
                             f"{label}: the library's static plan {got} != "
                             f"static_plan {want}"))
    return out


def check_evolve_max_d(k: int, L: int, device: str = "cpu") -> list:
    """The resident EvolveGCN's refusal names the widest D that fits:
    smem(max_d) <= SMEM_LIMIT < smem(max_d + ROW_ALIGN) (on the card by
    the library's figure too)."""
    d = engine.evolve_resident_max_d(k, L)
    sizes = {"smem_bytes": lambda D: engine.smem_bytes(
        "evolve_engine", k=k, L=L, D=D)}
    if device == "cuda":
        sizes["library_smem_bytes"] = lambda D: engine.library_smem_bytes(
            "evolve_engine", k=k, L=L, D=D)
    out = []
    for what, size in sizes.items():
        if not size(d) <= engine.SMEM_LIMIT < size(d + engine.ROW_ALIGN):
            out.append(_find(
                "vmem-bytes-drift",
                f"evolve_resident_max_d(k={k}, L={L}) = {d}, but by {what} "
                f"D {d} needs {size(d)} B and D {d + engine.ROW_ALIGN} "
                f"{size(d + engine.ROW_ALIGN)} B against the "
                f"{engine.SMEM_LIMIT}-byte limit"))
    return out


# ------------------------------------------------------- the protocol --

def _ring_groups(rows) -> dict:
    groups = {}
    for row in rows:
        groups.setdefault((int(row[0]), int(row[1])), []).append(row)
    return groups


def _replay_ring(label: str, cta: int, ring: int, rows, depth: int,
                 lengths) -> list:
    """One (CTA, ring)'s rows in its logging thread's order against the
    ring's protocol and the sweeps the launch's data needs."""
    out = []
    tag = f"{label}: CTA {cta} ring {ring} (depth {depth})"
    outstanding, issued, waited = {}, [], []
    bad_slot = False
    for row in rows:
        seq, slot, parity, window, event = (int(v) for v in row[2:7])
        if not bad_slot and (slot != seq % depth
                             or parity != (seq // depth) & 1):
            bad_slot = True
            out.append(_find("dma-ring-order",
                             f"{tag}: window {seq} logged in slot {slot} "
                             f"parity {parity}, not slot {seq % depth} "
                             f"parity {(seq // depth) & 1}"))
        if event == engine.EV_ISSUE:
            if slot in outstanding:
                out.append(_find("dma-ring-order",
                                 f"{tag}: window {seq} reissued slot {slot} "
                                 f"while window {outstanding[slot]} in it was "
                                 "not yet waited"))
            outstanding[slot] = seq
            issued.append((seq, window))
        elif event == engine.EV_WAIT:
            if slot not in outstanding:
                out.append(_find("dma-unpaired-start",
                                 f"{tag}: wait on window {seq} (slot {slot}) "
                                 "with no outstanding issue"))
            outstanding.pop(slot, None)
            waited.append((seq, window))
        else:
            out.append(_find("dma-ring-order",
                             f"{tag}: unknown event {event} on window {seq}"))
    for slot, seq in sorted(outstanding.items()):
        out.append(_find("dma-unpaired-start",
                         f"{tag}: window {seq} (slot {slot}) issued but "
                         "never waited before the launch ended"))
    want = [(s0 + i, i) for s0, m in zip(np.cumsum([0, *lengths[:-1]]),
                                         lengths) for i in range(m)]
    want = [(int(s), w) for s, w in want]
    for what, got in (("issued", issued), ("waited", waited)):
        if got != want:
            first = next((j for j, (g, w) in enumerate(zip(got, want))
                          if g != w), min(len(got), len(want)))
            out.append(_find(
                "dma-ring-order",
                f"{tag}: {what} {len(got)} windows, the sweeps "
                f"{list(lengths)} need {len(want)} in order; first "
                f"difference at entry {first}: "
                f"{got[first] if first < len(got) else None} against "
                f"{want[first] if first < len(want) else None}"))
    return out


def _replay_planes(label: str, log, groups) -> list:
    """EvolveGCN's W planes: each CTA's each layer reads at step t the
    plane step t-1 wrote (plane 0 first), writes exactly on live steps (the
    other plane resident; the one plane paged) and returns the plane
    written last."""
    out = []
    rows = [r for key, g in groups.items()
            if key[1] in (engine.RING_PLANE_READ, engine.RING_PLANE_WRITE)
            for r in g]
    if log.planes is None:
        if rows:
            out.append(_find("pingpong-parity",
                             f"{label}: {log.name} holds no W planes but "
                             f"logged {len(rows)} plane row(s)"))
        return out
    reads, writes, finals = {}, {}, {}
    for r in rows:
        cta, t, plane, l, ev = (int(r[0]), int(r[2]), int(r[3]), int(r[5]),
                                int(r[6]))
        book = {engine.EV_READ: reads, engine.EV_WRITE: writes,
                engine.EV_FINAL: finals}.get(ev)
        if book is None:
            out.append(_find("pingpong-parity",
                             f"{label}: CTA {cta} unknown plane event {ev}"))
            continue
        key = (cta, l) if ev == engine.EV_FINAL else (cta, l, t)
        book[key] = plane
    for cta in range(log.B * engine.CLUSTER):
        b = cta // engine.CLUSTER
        for l in range(log.L):
            live = 0
            tag = f"{label}: CTA {cta} layer {l}"
            for t in range(log.T):
                r = reads.get((cta, l, t))
                w = writes.get((cta, l, t))
                on = bool(log.live[b, t])
                if r != live:
                    out.append(_find("pingpong-parity",
                                     f"{tag}: step {t} read plane {r}, but "
                                     f"the live W is in plane {live}"))
                    break
                if on != (w is not None):
                    did = "wrote no plane" if on else f"wrote plane {w}"
                    out.append(_find("pingpong-parity",
                                     f"{tag}: step {t} is "
                                     f"{'live' if on else 'dead'} but {did}"))
                    break
                if on:
                    want = r if log.planes == 1 else 1 - r
                    if w != want:
                        out.append(_find("pingpong-parity",
                                         f"{tag}: step {t} read plane {r} "
                                         f"and wrote plane {w}, not {want}"))
                        break
                    live = w
            else:
                f = finals.get((cta, l))
                if f != live:
                    out.append(_find("pingpong-parity",
                                     f"{tag}: the W returned is plane {f}, "
                                     f"but the last write went to plane "
                                     f"{live}"))
    return out


def replay(log, label: str) -> list:
    """Replay a launch's ``engine.ProtoLog``: its rings against their
    protocol and the sweeps its data needs, and EvolveGCN's planes."""
    out = []
    if log.overflow:
        out.append(_find("dma-missing-site",
                         f"{label}: {log.name}'s protocol log overflowed "
                         f"({log.count} rows appended, room for "
                         f"{log.capacity}): rows were dropped"))
    groups = _ring_groups(log.rows)
    for (cta, ring), rows in sorted(groups.items()):
        if ring not in (engine.RING_STATE, engine.RING_GRU):
            continue
        if ring not in log.depth:
            out.append(_find("dma-missing-site",
                             f"{label}: {log.name} has no ring {ring} (a "
                             f"resident launch) but CTA {cta} logged "
                             f"{len(rows)} row(s) on it"))
            continue
        out += _replay_ring(label, cta, ring, rows, log.depth[ring],
                            list(log.sweeps.get((cta, ring), ())))
    for (cta, ring), lengths in sorted(log.sweeps.items()):
        if (cta, ring) not in groups:
            out.append(_find("dma-missing-site",
                             f"{label}: CTA {cta} never issued ring {ring}, "
                             f"whose sweeps {list(lengths)} its live tiles "
                             "need"))
    return out + _replay_planes(label, log, groups)


def launch_logged(rec):
    """Launch a recorded launch again on the card with its protocol log;
    returns the ``ProtoLog``."""
    pos, kw = rec.call
    dev = lambda t: t.to("cuda") if torch.is_tensor(t) else t
    with torch.no_grad():
        return getattr(engine, rec.name)(
            *(dev(t) for t in pos), **{k: dev(v) for k, v in kw.items()},
            proto=True)[-1]


# ----------------------------------------------------------- the pass --

def run_contracts(points=None, rules: Optional[frozenset] = None,
                  device: str = "cpu") -> list:
    """Every sweep point recorded and checked; each stateful launch's
    protocol log replayed (``device="cuda"``: the kernel's own log, and
    the library's shared memory, cluster launches and static plan)."""
    findings = []
    pts = registry_points() if points is None else points
    evolve_kl = set()
    for point in pts:
        label = point.label()
        try:
            recs = record_point(point)
        except ASSEMBLY_ERRORS as exc:
            findings.append(_find(
                "launch-assembly-error",
                f"{label}: launch assembly failed: "
                f"{type(exc).__name__}: {exc}"))
            continue
        if not recs:
            findings.append(_find(
                "launch-assembly-error",
                f"{label}: no launch recorded — dispatch bypassed the "
                "engine wrappers (force-ref gate left on?)"))
            continue
        for rec in recs:
            if rec.name != point.kernel():
                findings.append(_find(
                    "launch-assembly-error",
                    f"{label}: recorded a launch of {rec.name}, expected "
                    f"{point.kernel()}"))
                continue
            findings += check_smem(label, rec, device)
            if rec.name == "static_engine":
                findings += check_static(label, rec)
                continue
            findings += check_aliases(label, rec)
            if rec.name == "evolve_engine":
                evolve_kl.add((rec.dims["k"], rec.dims["L"]))
            try:
                log = (launch_logged(rec) if device == "cuda"
                       else engine.protocol_of(rec))
            except ASSEMBLY_ERRORS as exc:
                findings.append(_find(
                    "launch-assembly-error",
                    f"{label}: the launch with its protocol log failed: "
                    f"{type(exc).__name__}: {exc}"))
                continue
            findings += replay(log, label)
    for k, L in sorted(evolve_kl):
        findings += check_evolve_max_d(k, L, device)
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    return findings
