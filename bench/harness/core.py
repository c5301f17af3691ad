"""One run of one cell: set-up, the measured window, the check of what the
timed path produced, and the metrics.

Everything that belongs to one configuration, traffic mix, call shape or
metric is found by its name from ``BENCHMARK.json``:

* the configuration's file (``configs[].file``), which names the port's
  model and plan, the engine source to build and its kernel's name, and
  the limits of the comparison;
* ``bench/reference/<config>.py``: the plain reference, and the
  parameters the benchmark makes;
* ``bench/work/<config>.py``: the operations and bytes of a stream;
* ``bench/traffic/<traffic>.json``: the stream pool, how calls take
  streams from it, the ``driver`` that makes the calls (``replay`` where
  it names none) and a ``plan`` merged over the configuration's;
* ``bench/drivers/<driver>.py``: everything between the seed and a call's
  outputs, the system under test's side: the pool (where the driver makes
  its own), the inputs' ingest, the session, and the timed calls, each
  with the label of its root span;
* ``bench/metrics/<metric>.py``: one reader a metric.

A call counts once its outputs are synchronised.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from bench.harness import peaks as _peaks
from bench.harness import streams as _streams
from bench.harness import trace as _trace
from bench.harness.stats import percentile

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The run's device is missing: the run fails and prints no result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str, name: str):
    """The Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded."""

    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    reference: object
    work: object
    driver: object

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        root = Path(root)
        man = load_json(root / "BENCHMARK.json")
        wl = {w["name"]: w for w in man["workloads"]}.get(name)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg_entry = {c["name"]: c for c in man["configs"]}[wl["config"]]
        bench = root / "bench"
        traffic = load_json(bench / "traffic" / f"{wl['traffic']}.json")
        driver = traffic.get("driver", "replay")
        return cls(root, man, wl, load_json(root / cfg_entry["file"]),
                   traffic,
                   load_module(bench / "reference" / f"{wl['config']}.py",
                               "reference", wl["config"]),
                   load_module(bench / "work" / f"{wl['config']}.py",
                               "work", wl["config"]),
                   load_module(bench / "drivers" / f"{driver}.py",
                               "driver", driver))

    @property
    def plan(self) -> dict:
        """The session's plan fields: the configuration's ``plan``, with the
        traffic's ``plan`` merged over it."""
        return {**self.config["plan"], **self.traffic.get("plan", {})}

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports: the end-to-end ones without a
        trace, the per-layer ones with it."""
        specs = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in specs
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]

    def reader(self, metric: str):
        return load_module(self.root / "bench" / "metrics" / f"{metric}.py",
                           "metric", metric)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def call_groups(traffic: dict, P: int) -> list:
    """The pool indices each call takes, in turn: consecutive groups of
    ``streams_per_call`` streams, cycled."""
    k = traffic["streams_per_call"]
    if P % k:
        raise ValueError(f"a pool of {P} streams does not split into calls "
                         f"of {k}")
    return [list(range(i, i + k)) for i in range(0, P, k)]


def compare(prog_outs: list, prog_states: list, ref_outs: list,
            ref_states: list) -> dict:
    """The numbers held to the limits: ``out_rel``, the largest gap of any
    output element (padding rows included, where the reference is zero)
    over the reference's largest |output|; ``state_rel``, per state leaf
    the largest gap over that leaf's largest |value|, the worst leaf. A
    shape that differs, or a gap that is not finite, reads inf."""
    def rel(got: list, want: list) -> float:
        gap = scale = 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape:
                return math.inf
            d = float((g.float() - w).abs().max()) if w.numel() else 0.0
            if not math.isfinite(d):
                return math.inf
            gap = max(gap, d)
            scale = max(scale, float(w.abs().max()) if w.numel() else 0.0)
        return gap / scale if scale else math.inf

    return {"out_rel": rel(prog_outs, ref_outs),
            "state_rel": max(rel([s[k] for s in prog_states],
                                 [s[k] for s in ref_states])
                             for k in ref_states[0])}


def within_limits(checks: dict, limits: dict) -> bool:
    """Whether every number compared is finite and at most its limit: the
    test that decides ``correct`` (with no failed call), and that a
    control has to fail."""
    return all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())


class Reservoir:
    """One item a key, drawn uniformly from every item offered under that
    key (reservoir sampling): the n-th replaces the one kept with
    probability 1 / n, by a generator drawn from the run's seed."""

    def __init__(self, rng):
        self.rng, self.seen, self.kept = rng, {}, {}

    def offer(self, key, item) -> None:
        n = self.seen[key] = self.seen.get(key, 0) + 1
        if self.rng.random() * n < 1.0:
            self.kept[key] = item


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else \
        "not read"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_process: float | None = None, out_dir=None,
        control: bool = False) -> dict:
    """One run of ``workload``. Returns the result line's object, its
    ``checks`` last. Raises ``NoDevice`` where the cell's cards are
    missing; ``device="cpu"`` runs the port's plain path and measures
    nothing of a device. With ``control`` the reference in TF32 is judged
    in the program's place too (``control_checks``, before ``checks``)."""
    t_process = time.time() if t_process is None else t_process
    stages = {"start": time.time() - t_process}
    cell = Cell.load(root, workload)
    dev = torch.device(device)
    chips = cell.workload["chips"]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {chips}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    widths, bucket = cfg["widths"], traffic["bucket"]
    if dev.type == "cuda":
        from repro_torch.kernels import engine

        engine.build([cfg["engine"]["source"]])
        torch.cuda.init()
    stages["build_and_context"] = time.time() - t_process

    # ---- set-up: inputs, the driver's ingest, params, session, warm-up ----
    drv = cell.driver
    make_pool = getattr(drv, "make_pool", _streams.generate_pool)
    pool = make_pool(traffic, seed, widths["in_dim"], widths["edge_dim"])
    most = _streams.check_fits(pool, bucket)
    work = [cell.work.count(s, widths) for s in pool]
    stages["generate"] = time.time() - t_process
    inputs = drv.ingest(pool, bucket, dev)
    stages["ingest_and_upload"] = time.time() - t_process
    G = max(s.n_global for s in pool)
    gen = torch.Generator(device=dev).manual_seed(seed % _streams.SEED_MOD)
    params = cell.reference.make_params(widths, gen, dev)
    session = drv.make_session(cell, params, G, dev, inputs)
    groups = call_groups(traffic, len(pool))
    calls = [drv.make_call(session, inputs, g, cell.reference.port_state)
             for g in groups]
    shapes: dict = {}
    for i, g in enumerate(groups):
        shapes.setdefault(tuple(pool[j].T for j in g), i)
    stages["session"] = time.time() - t_process
    for i in shapes.values():  # every shape the window uses, once
        calls[i][0]()
    _sync(dev)
    stages["warm_up"] = time.time() - t_process

    # what the check keeps: each group's outputs and states from one of
    # its calls, drawn uniformly over the whole window
    kept = Reservoir(_streams.rng_for(seed, 1 << 20))

    # ---- the measured window: calls back to back, one client, for
    # ``seconds`` and at least one round of the groups, so that the check
    # has every stream ----
    rec = []      # (t0, t_return, t_end, live snapshots, label, group)
    attempted = failed = 0
    first_error = None
    prof = marks = None
    # the set-up's objects are collected once and frozen out of the
    # window's collections, which stay on as a user's process has them
    gc.collect()
    gc.freeze()
    if trace:
        prof = _trace.start()
        marks = [_trace.mark()]
    setup_s = time.time() - t_process
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if attempted >= len(calls) and t0 - t_start >= seconds:
            break
        gi = attempted % len(calls)
        fn, label = calls[gi]
        attempted += 1
        try:
            outs, states = fn()
            t1 = time.perf_counter()
            _sync(dev)
        except (RuntimeError, ValueError) as exc:
            failed += 1
            first_error = first_error or repr(exc)
            continue
        t2 = time.perf_counter()
        rec.append((t0, t1, t2, sum(pool[j].T for j in groups[gi]), label,
                    gi))
        kept.offer(gi, (outs, states))
        outs = states = None
    t_stop = rec[-1][2] if rec else time.perf_counter()
    gc.unfreeze()
    trace_info = None
    if trace:
        trace_info = _trace.finish(prof, marks, t_stop, out_dir, workload)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    clusters = None
    if dev.type == "cuda":
        from repro_torch.kernels import engine

        clusters = engine.library_engine_cluster_config(
            cfg["engine"]["source"], traffic["streams_per_call"],
            **cfg["engine"]["dims"]).get("max_active_clusters")
    del session, inputs, calls
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check, after the window: the plain reference ----
    layout = getattr(drv, "layout", None)
    got = {}
    for gi, item in kept.kept.items():
        outs, states = layout(*item, dev) if layout else item
        got.update((j, (outs[b], states[b]))
                   for b, j in enumerate(groups[gi]))
    del kept
    order = sorted(got)
    limits = dict(cfg["limits"], streams_unchecked=0.0)
    checks = {k: math.inf for k in cfg["limits"]}
    if order:
        ref_outs, ref_states = cell.reference.reference(
            params, [pool[j] for j in order], bucket["n_pad"], G, dev)
        checks = compare([got[j][0] for j in order],
                         [got[j][1] for j in order], ref_outs, ref_states)
    checks["streams_unchecked"] = float(len(pool) - len(order))
    control_checks = None
    if control and order:
        low_outs, low_states = cell.reference.reference(
            params, [pool[j] for j in order], bucket["n_pad"], G, dev,
            low=True)
        control_checks = compare(low_outs, low_states, ref_outs, ref_states)
    correct = failed == 0 and bool(rec) and within_limits(checks, limits)

    # ---- metrics, each from its own reader ----
    totals = {"engine_flops": 0.0, "engine_bytes": 0.0, "step_flops": 0.0}
    for r in rec:
        for j in groups[r[5]]:
            for k in totals:
                totals[k] += work[j][k]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = SimpleNamespace(
        calls=rec, window_s=t_stop - t_start, setup_s=setup_s,
        live=sum(r[3] for r in rec), totals=totals, trace=trace_info,
        config=cfg, peaks=_peaks.peaks_for(kind))
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_obj = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": kind, "count": chips,
                  "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_obj}
    if trace_info is not None:
        device_obj["busy_s"] = trace_info.busy_s
        device_obj["window_s"] = trace_info.window_s
        result["breakdown"] = _trace.breakdown(trace_info, rec)
    call_s = [r[2] - r[0] for r in rec]
    log("info " + json.dumps({
        "workload": workload, "seed": seed, "seconds": seconds,
        "trace": trace, "card": power_limit() if dev.type == "cuda" else "",
        "max_active_clusters": clusters, "calls": len(rec),
        "live_snapshots": ctx.live,
        "padded_slots": sum(len(groups[r[5]])
                            * max(pool[j].T for j in groups[r[5]])
                            for r in rec),
        "call_ms_p50": 1e3 * percentile(call_s, 50) if rec else None,
        "call_ms_p95": 1e3 * percentile(call_s, 95) if rec else None,
        "window_s": ctx.window_s, "setup_s": setup_s,
        "setup_stages_cumulative_s": stages,
        "largest_nodes_edges_degree": most, "first_error": first_error}))
    if control_checks is not None:
        result["control_checks"] = {k: {"value": v, "limit": limits[k]}
                                    for k, v in control_checks.items()}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def __getattr__(name: str):
    """``ingest``, ``make_session`` and ``make_call``, which the replay
    driver (``bench/drivers/replay.py``) now holds, for callers that still
    take them from here (``tools/session_spans.py cost``)."""
    if name in ("ingest", "make_session", "make_call"):
        path = Path(__file__).resolve().parents[1] / "drivers" / "replay.py"
        return getattr(load_module(path, "driver", "replay"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
