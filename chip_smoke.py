#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: card name and power limit, torch / CUDA versions, TF32 off;
  2. build all eight kernels from src/repro_torch/kernels/csrc (one nvcc per
     source, all at once);
  3. every kernel against its plain PyTorch version on the card:
     a. narrow odd widths with partial node tiles, ragged with a length-0
        row, with and without edge messages / the static edge term
        (<= 1e-4: fp32 with TF32 off, only the order of summation differs);
     b. the five stream engines at full width (BC-Alpha, n_pad 640,
        G 3468): a T = 8, B = 2 ragged case (<= 1e-4) and the main path's
        own shapes (all 137 steps, 176 TGN event batches or 137 static
        slots; <= 1e-3 for the recurrences, which compound sum-order
        differences, <= 1e-4 for the static GCN);
     c. the three per-step kernels (V2 steps, ELL SpMM) on the inputs the
        main path hands them at full width, recorded from one run of a path
        that launches each, every step of the stream (<= 1e-4);
     each timed with CUDA events beside its bound, and the ELL SpMM beside
     torch.sparse.mm of the same matrix;
  4. main path: every level of GCRN-M2, EvolveGCN-O, the stacked
     GCN -> GRU, TGN and the static GCN through BoosterSession (run on the
     whole BC-Alpha stream, run_batched over windows: ragged at v3, equal at
     the per-step levels), and build_model(cfg, impl="pallas") with
     run_plan / run_plan_batched at the per-step levels. TGN runs on the
     BC-Alpha events (sorted by time, batches of 200: 176 event batches),
     the others on the 137 snapshots. The launch counts are set to 0 just
     before each path and read just after it; each path's results are held
     against its force-ref run on the card (<= 1e-3).
  5. the device's busy share of one run at baseline, v2 and v3 (kernel
     time over wall time, torch.profiler).
  6. a probe of where a live node tile's time goes: gcrn_step on
     synthetic full-width inputs that vary live rows, lanes and widths.
Prints ms/snapshot per path, a {"kernels": [...]} line and, last, the
device line.

Imports nothing of the JAX package.
"""
import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs.dgnn import (BC_ALPHA, EVOLVEGCN, GCRN_M2,  # noqa: E402
                                      STACKED, STATIC_GCN, TGN)
from repro_torch.core.dataflow import (build_model, init_states_batched,  # noqa: E402
                                       run_plan, run_plan_batched,
                                       stack_time)
from repro_torch.core.evolvegcn import layer_dims  # noqa: E402
from repro_torch.graph import (generate_temporal_graph, max_in_degree,  # noqa: E402
                               pad_event_block, pad_snapshot,
                               renumber_and_normalize, slice_snapshots)
from repro_torch.graph.padding import PaddedSnapshot, stack_ragged  # noqa: E402
from repro_torch.kernels import engine, ops  # noqa: E402

# published H100 SXM peaks: fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
TOL_KERNEL = 1e-4
TOL_STREAM = 1e-3
N_PAD = 640
SEED = 0
CONFIGS = (GCRN_M2, EVOLVEGCN, STACKED, TGN, STATIC_GCN)
# TGN's event batches: the TGN paper's batch size
EVENT_BATCH = 200
# run_batched windows of the stream: ragged at v3 (the stream engine's
# lengths), equal at the per-step levels (which need equal T)
V3_WINDOWS = ((0, 137), (0, 100), (40, 137), (0, 64))
STEP_WINDOWS = ((0, 45), (46, 91), (92, 137))
# the same over TGN's 176 event batches
EVENT_V3_WINDOWS = ((0, 176), (0, 120), (50, 176), (0, 64))
EVENT_STEP_WINDOWS = ((0, 58), (59, 117), (118, 176))
# the T = 8, B = 2 ragged engine check at full width (lengths 8 and 5)
CHECK_WINDOWS = ((0, 8), (40, 48))
# timed repeats of each main path's run after the checked one
RUN_REPS = 3
SRC = "src/repro_torch/kernels/csrc"
# the stream-engine kernel of each family
ENGINE = {"gcrn": "gcrn_engine", "evolve": "evolve_engine",
          "stacked": "stacked_engine", "tgn": "tgn_engine",
          "static_gcn": "static_engine"}
REPLACES = {
    "gcrn_engine": "src/repro/kernels/stream_fused.py:833",
    "evolve_engine": "src/repro/kernels/stream_fused.py:1191",
    "stacked_engine": "src/repro/kernels/stream_fused.py:1015",
    "tgn_engine": "src/repro/kernels/stream_fused.py:1381",
    "static_engine": "src/repro/kernels/stream_fused.py:1562",
    "gcrn_step": "src/repro/kernels/dgnn_fused.py:58",
    "stacked_step": "src/repro/kernels/dgnn_fused.py:119",
    "ell_spmm": "src/repro/kernels/csr_spmm.py:47",
}


def log(*a):
    print(*a, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (not an ``assert``: ``-O`` drops those)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flat(r) -> list:
    """Tensors of a (nested) result: tuples, lists and state dicts."""
    if isinstance(r, dict):
        return [x for k in sorted(r) for x in flat(r[k])]
    if isinstance(r, (tuple, list)):
        return [x for y in r for x in flat(y)]
    return [r]


def max_err(a, b) -> float:
    """Largest absolute difference of two results (0 for two empty
    states)."""
    a, b = flat(a), flat(b)
    check(len(a) == len(b), "results of different structure")
    return max((float((x - y).abs().max()) for x, y in zip(a, b)),
               default=0.0)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bc_alpha():
    """The whole BC-Alpha stream padded into one bucket (numpy)."""
    tg, feat = generate_temporal_graph(BC_ALPHA, feat_dim=GCRN_M2.in_dim)
    locs = [renumber_and_normalize(s) for s in slice_snapshots(tg, 1.0)]
    k_max = max(4, max(max_in_degree(ls) for ls in locs))
    e_pad = max(ls.src.shape[0] for ls in locs)
    n_max = max(ls.n_nodes for ls in locs)
    check(n_max <= N_PAD, f"max nodes {n_max} > n_pad {N_PAD}")
    stream = stack_time([pad_snapshot(ls, feat, N_PAD, e_pad, k_max)
                         for ls in locs])
    log(f"bc-alpha: T={len(locs)} n_global={tg.n_global_nodes} "
        f"n_pad={N_PAD} e_pad={e_pad} k_max={k_max} max_nodes={n_max}")
    return stream, tg.n_global_nodes


def bc_alpha_events():
    """The BC-Alpha interactions as TGN event batches (numpy): sorted by
    time (stable), batches of ``EVENT_BATCH``, n_pad 640, k_max the most
    events a node has in one batch."""
    tg, feat = generate_temporal_graph(BC_ALPHA, feat_dim=TGN.in_dim)
    order = np.argsort(tg.time, kind="stable")
    src, dst, ts = tg.src[order], tg.dst[order], tg.time[order]
    cuts = range(0, src.size, EVENT_BATCH)
    k_max = max(int(np.unique(np.concatenate(
        [src[a:a + EVENT_BATCH], dst[a:a + EVENT_BATCH]]),
        return_counts=True)[1].max()) for a in cuts)
    blocks = [pad_event_block(src[a:a + EVENT_BATCH], dst[a:a + EVENT_BATCH],
                              ts[a:a + EVENT_BATCH], feat, N_PAD, k_max)
              for a in cuts]
    touched = [int(b.n_nodes) for b in blocks]
    log(f"bc-alpha events: {src.size} events, T={len(blocks)} batches of "
        f"{EVENT_BATCH}, n_global={tg.n_global_nodes} n_pad={N_PAD} "
        f"k_max={k_max} touched nodes {min(touched)}-{max(touched)} "
        f"(mean {np.mean(touched):.1f}), ts {ts.min()}-{ts.max()}")
    return stack_time(blocks)


def window(s, a: int, b: int):
    """Entries [a, b) of a padded snapshot or event-block stream."""
    return type(s)(**{k: v[a:b] for k, v in vars(s).items()})


def batch_of(s: PaddedSnapshot, wins) -> PaddedSnapshot:
    """B windows of one stream stacked to the longest (ragged)."""
    return stack_ragged([window(s, a, b) for a, b in wins], "cuda")[0]


# ------------------------------------------------------- bound counts ----

def _live(coef):
    """(rows with a nonzero lane, nonzero lanes) of (..., n, k) coef."""
    live = coef != 0
    return float(live.any(-1).sum()), float(live.sum()), live


def _distinct(index, live, rows_per_graph: int) -> int:
    """Distinct (graph, row) pairs the live lanes of (..., n, k) read."""
    graph = torch.arange(index[..., 0, 0].numel(), device=index.device)
    graph = graph.view(*index.shape[:-2], 1, 1) * rows_per_graph
    return torch.unique((graph + index)[live]).numel()


def gcrn_cost(inp):
    """(flop, bytes) the GCRN engine's function needs on these inputs: the
    ELL lanes, x row and row id of each real row (mask != 0), the edge
    messages its live lanes read, the weights, the stores in and out, the
    per-step h output, and the gather / scatter of each real row's h and c."""
    idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, em = inp
    B, T, n, k = idx.shape
    din, h = x.shape[-1], h0.shape[-1]
    rows = float((mask != 0).sum())
    _, lanes, live = _live(coef)
    flops = 2 * rows * (din + h) * 4 * h + 2 * lanes * (din + h)
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    if em is not None:
        byts += _distinct(eidx, live, em.shape[2]) * din * 4
    byts += nbytes(wx, wh, b) + 2 * nbytes(h0, c0) + B * T * n * h * 4
    byts += rows * 2 * h * 4 * 2
    return flops, byts


def stacked_cost(inp):
    """(flop, bytes) the stacked engine's function needs on these inputs:
    as ``gcrn_cost``, with the NT product and the GRU against the own row
    in place of the gate product, one store (h) instead of two."""
    idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b, em = inp
    B, T, n, k = idx.shape
    din, dmid, h = x.shape[-1], wg.shape[1], h0.shape[-1]
    rows = float((mask != 0).sum())
    _, lanes, live = _live(coef)
    flops = (2 * rows * (din * dmid + dmid * 3 * h + h * 3 * h)
             + 2 * lanes * din)
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    if em is not None:
        flops += lanes * din
        byts += _distinct(eidx, live, em.shape[2]) * din * 4
    byts += nbytes(wg, bg, wx, wh, b) + 2 * nbytes(h0) + B * T * n * h * 4
    byts += rows * h * 4 * 2
    return flops, byts


def evolve_cost(inp, dims):
    """(flop, bytes) the EvolveGCN kernel's function needs on these inputs,
    at each layer's true widths ``dims``: the ELL lanes and x row of each
    real row, its edge term at each layer's input width, the live flags,
    the weights in and out, the GCN and GRU params, and the output."""
    idx, coef, x, mask, live, *_ = inp
    B, T, n, k = idx.shape
    rows = float((mask != 0).sum())
    lanes = float((coef != 0).sum())
    n_live = float(live.sum())
    flops = 0.0
    for din, dout in dims:
        flops += 2 * lanes * din + 2 * rows * din * dout
        flops += n_live * 2 * (2 * dout * din * 3 * din)
    byts = nbytes(mask, live) + rows * (k * 2 * 4 + dims[0][0] * 4)
    if inp[-1] is not None:
        byts += rows * sum(din for din, _ in dims) * 4
    byts += B * T * n * dims[-1][1] * 4
    byts += 4 * sum(2 * B * din * dout + dout + 2 * din * 3 * din + 3 * din
                    for din, dout in dims)
    return flops, byts


def tgn_cost(inp):
    """(flop, bytes) the TGN engine's function needs on these inputs: per
    touched row (mask != 0) its lanes' ids, coefs and times, its x row and
    row id, the input projection and the GRU; per live lane and column the
    two aggregations, ts * freq and one cos (counted as one operation); the
    weights, the store in and out, the per-batch outputs, and the gather /
    scatter of each touched row's memory (partners are touched rows of the
    same batch, so their reads are those gathers)."""
    gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b = inp
    B, T, n, k = gidx.shape
    din, h = x.shape[-1], mem0.shape[-1]
    rows = float((mask != 0).sum())
    lanes = float((coef != 0).sum())
    flops = (2 * rows * (din * h + 2 * h * 3 * h)
             + lanes * h * (2 * 2 + 1 + 1))
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    byts += nbytes(freq, w_in, wx, wh, b) + 2 * nbytes(mem0)
    byts += B * T * n * h * 4 + rows * h * 4 * 2
    return flops, byts


def static_cost(inp, dims):
    """(flop, bytes) the static GCN kernel's function needs on these
    inputs, at each layer's true widths ``dims``: per real row (mask != 0)
    its lanes, its x row, its edge term at layer 0's input width and each
    layer's product; per live lane each layer's aggregation; the shared
    weights once; the output at its true width."""
    idx, coef, x, mask, w, bg, eagg = inp
    B, T, n, k = idx.shape
    rows = float((mask != 0).sum())
    lanes = float((coef != 0).sum())
    flops = sum(2 * lanes * din + 2 * rows * din * dout
                for din, dout in dims)
    byts = nbytes(mask) + rows * (k * 2 * 4 + dims[0][0] * 4)
    if eagg is not None:
        flops += rows * dims[0][0]
        byts += rows * dims[0][0] * 4
    byts += 4 * sum(din * dout + dout for din, dout in dims)
    byts += B * T * n * dims[-1][1] * 4
    return flops, byts


def ell_cost(call):
    """(flop, bytes) of one ELL SpMM: the lanes of rows with a live lane,
    the x rows and edge rows the live lanes read, the whole output."""
    idx, coef, eidx, x, em = call
    n, k, d = idx.shape[-2], idx.shape[-1], x.shape[-1]
    rows, lanes, live = _live(coef)
    flops = 2 * lanes * d
    byts = rows * k * 4 * 2 + _distinct(idx, live, x.shape[-2]) * d * 4
    if em is not None:
        flops += lanes * d
        byts += rows * k * 4 + _distinct(eidx, live, em.shape[-2]) * d * 4
    return flops, byts + n * d * 4


def gcrn_step_cost(call):
    """(flop, bytes) of one V2 GC-LSTM step: the gate product of rows with
    a live lane (a row without one takes the bias as its gates), the ELL
    lanes of those rows, the x / h / edge rows live lanes read, every c
    row, the weights, the h and c outputs."""
    idx, coef, eidx, x, h, c, wx, wh, b, em = call
    n, k = idx.shape
    din, H = x.shape[1], h.shape[1]
    rows, lanes, live = _live(coef)
    src = _distinct(idx, live, n)
    flops = 2 * rows * (din + H) * 4 * H + 2 * lanes * (din + H)
    byts = rows * k * 4 * 2 + src * (din + H) * 4 + nbytes(c, wx, wh, b)
    if em is not None:
        flops += lanes * din
        byts += rows * k * 4 + _distinct(eidx, live, em.shape[0]) * din * 4
    return flops, byts + 2 * n * H * 4


def stacked_step_cost(call):
    """(flop, bytes) of one V2 GCN -> GRU step: the NT product of rows with
    a live lane (nt = bg on the others), the GRU of rows with a live lane or
    a nonzero h (the rest share one value), the ELL lanes, the x / edge
    rows live lanes read, every h row, the weights, the output."""
    idx, coef, eidx, x, h, wg, bg, wx, wh, b, em = call
    n, k = idx.shape
    din, dmid, H = x.shape[1], wg.shape[1], h.shape[1]
    rows, lanes, live = _live(coef)
    gru_rows = float((live.any(-1) | (h != 0).any(-1)).sum()) + 1
    flops = (2 * lanes * din + 2 * rows * din * dmid
             + 2 * gru_rows * (dmid * 3 * H + H * 3 * H))
    byts = (rows * k * 4 * 2 + _distinct(idx, live, n) * din * 4
            + nbytes(h, wg, bg, wx, wh, b))
    if em is not None:
        flops += lanes * din
        byts += rows * k * 4 + _distinct(eidx, live, em.shape[0]) * din * 4
    return flops, byts + n * H * 4


def bound(flops, byts):
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, byts / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------ kernels ----

def kernel_inputs(model, params, snaps, lengths=None):
    """The kernel wrapper's inputs for a (B, T, ...) batch: the model's
    stream arguments, packed by kernels/ops.py as the main path packs them
    (the static GCN's (B, T) snapshots folded onto (B * T, 1) slots, its
    lengths turned into per-slot liveness, as StaticGCN does)."""
    if model.stream_family == "static_gcn":
        snaps, lengths = model.fold_slots(snaps, lengths)
    B = snaps.node_mask.shape[0]
    state = init_states_batched(model, params, B)
    return ops.pack(model.stream_family,
                    *model.stream_args(params, state, snaps), lengths=lengths)


def record(name: str, **kw):
    """A stream engine's JSON record with the keys every kernel carries."""
    return {"name": name, "route": "cuda", "source": f"{SRC}/{name}.cu",
            "replaces": REPLACES[name], "launches": 0, "library_ms": None,
            **kw}


def check_engine(name, kernel, plain, check_inp, main_inp, cost, tol_main):
    """A stream engine vs its plain version on the card (the main path's
    inputs within ``tol_main``); its record."""
    got, want = kernel(*check_inp), plain(*check_inp)
    torch.cuda.synchronize()
    err_small = max_err(got, want)
    log(f"{name}: T=8 B=2 ragged max_abs_err={err_small:.3e} "
        f"(tol {TOL_KERNEL})")
    check(np.isfinite(err_small) and err_small <= TOL_KERNEL, name)
    got, want = kernel(*main_inp), plain(*main_inp)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"{name}: main-path shapes max_abs_err={err:.3e} (tol {tol_main})")
    check(np.isfinite(err) and err <= tol_main, name)
    ms = cuda_ms(lambda: kernel(*main_inp), reps=5)
    plain_ms = cuda_ms(lambda: plain(*main_inp), reps=2)
    flops, byts = cost(main_inp)
    bound_ms, bound_by = bound(flops, byts)
    log(f"{name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
        f"bound {bound_ms:.4f} ms ({flops:.3e} flop, {byts:.3e} B)")
    return record(name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by, err_t8_b2=err_small)


def static_wave_probe(inp):
    """What spreading the static GCN's slots over the SMs costs:
    static_engine on the main path's slots, timed on the first 132 (one an
    SM), on all of them, on those past 132, and on the slot with the most
    real rows alone (ms a launch, the wrapper included)."""
    idx, coef, x, mask, w, bg, eagg = inp
    B = idx.shape[0]
    rows = (mask != 0).sum(dim=(1, 2))
    big = int(rows.argmax())

    def pick(sel):
        take = lambda t: None if t is None else t[sel].contiguous()
        return (take(idx), take(coef), take(x), take(mask), w, bg, take(eagg))

    for label, sel in ((f"first {min(B, 132)} slots", slice(0, 132)),
                       (f"all {B} slots", slice(0, B)),
                       (f"the {max(B - 132, 0)} slots past 132",
                        slice(132, B)),
                       (f"the largest slot alone ({int(rows[big])} real "
                        "rows)", slice(big, big + 1))):
        args = pick(sel)
        if args[0].shape[0] == 0:
            continue
        log(f"static wave probe: {label}: "
            f"{cuda_ms(lambda: engine.static_engine(*args), reps=20):.4f} ms")


@contextlib.contextmanager
def recording(name: str):
    """Record the CUDA inputs of every call of the kernel wrapper
    ``engine.<name>`` (kernels/ops.py looks it up at each call)."""
    calls, original = [], getattr(engine, name)

    def wrapper(*args, **kwargs):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return original(*args, **kwargs)

    setattr(engine, name, wrapper)
    try:
        yield calls
    finally:
        setattr(engine, name, original)


def sparse_mm_inputs(call):
    """torch.sparse.mm's operands for a no-edge ELL SpMM call: the CSR
    matrix of its live lanes (duplicates summed) and x."""
    idx, coef, _, x, _ = call
    n = idx.shape[0]
    live = coef != 0
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
    with warnings.catch_warnings():  # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(
            torch.stack([rows[live], idx[live].long()]), coef[live],
            (n, x.shape[0]), check_invariants=True).coalesce().to_sparse_csr()
    return a, x


def check_step_kernel(name, plain, calls, timed, cost, library=None):
    """A per-step kernel vs its plain version on every recorded main-path
    call (<= 1e-4), then timed on the ``timed`` calls: the bare launches
    (prepared once), the plain version, and ``library`` (a list of
    zero-argument calls) where one PyTorch call computes the same
    function. Times and the bound are per call."""
    wrapper = getattr(engine, name)
    err = 0.0
    for c in calls:
        err = max(err, max_err(wrapper(*c), plain(*c)))
    torch.cuda.synchronize()
    log(f"{name}: {len(calls)} main-path calls max_abs_err={err:.3e} "
        f"(tol {TOL_KERNEL})")
    check(np.isfinite(err) and err <= TOL_KERNEL, name)
    prepared = [engine.prepare(name, *c) for c in timed]
    ms = cuda_ms(lambda: [engine.launch(p) for p in prepared], reps=5)
    plain_ms = cuda_ms(lambda: [plain(*c) for c in timed], reps=2)
    lib_ms = None
    if library is not None:
        lib_ms = cuda_ms(lambda: [f() for f in library], reps=5) / len(timed)
    costs = [cost(c) for c in timed]
    flops, byts = sum(f for f, _ in costs), sum(b for _, b in costs)
    bound_ms, bound_by = bound(flops, byts)
    n_t = len(timed)
    log(f"{name}: per call {ms / n_t:.4f} ms kernel, {plain_ms / n_t:.4f} ms "
        f"plain, bound {bound_ms / n_t:.5f} ms ({flops / n_t:.3e} flop, "
        f"{byts / n_t:.3e} B)"
        + ("" if lib_ms is None else f", torch.sparse.mm {lib_ms:.4f} ms"))
    return record(name, max_abs_err=err, ms=ms / n_t, plain_ms=plain_ms / n_t,
                  bound_ms=bound_ms / n_t, bound_by=bound_by,
                  library_ms=lib_ms, timed_calls=n_t)


def small_shapes_check():
    """Every kernel through ops at narrow widths and a node count that
    leaves a partial 32-row tile and a partial 8-row micro-tile (n = 37,
    H = 24, D = 16), random data from the seed, with and without edge
    messages, the stream engines ragged; each against its force-ref run
    (<= 1e-4)."""
    rng = np.random.default_rng(SEED)
    B, T, n, k, din, h, G, e = 3, 3, 37, 5, 12, 24, 90, 120
    nr = rng.integers(10, n + 1, (B, T))
    rows = np.arange(n) < nr[..., None]
    idx = (rng.random((B, T, n, k)) * nr[..., None, None]).astype(np.int32)
    coef = (rng.random((B, T, n, k)) * (rng.random((B, T, n, k)) > 0.4)
            * rows[..., None]).astype(np.float32)
    eidx = rng.integers(0, e, (B, T, n, k)).astype(np.int32)
    ren = np.where(rows, np.stack([[rng.permutation(G)[:n] for _ in range(T)]
                                   for _ in range(B)]), -1).astype(np.int32)
    mask = rows.astype(np.float32)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    x = f32(B, T, n, din) * mask[..., None]
    em = f32(B, T, e, din)
    lengths = [3, 1, 2]
    dims = [(din, 16), (16, 8)]
    cases = {
        "gcrn": (idx, coef, eidx, x, ren, mask, f32(B, G, h), f32(B, G, h),
                 f32(din, 4 * h), f32(h, 4 * h), f32(4 * h)),
        "stacked": (idx, coef, eidx, x, ren, mask, f32(B, G, h),
                    f32(din, 16), f32(16), f32(16, 3 * h), f32(h, 3 * h),
                    f32(3 * h)),
        "evolve": (idx, coef, x, mask, np.ones((B, T), np.int32),
                   [f32(B, *d) for d in dims], [f32(d[1]) for d in dims],
                   [f32(d[0], 3 * d[0]) for d in dims],
                   [f32(d[0], 3 * d[0]) for d in dims],
                   [f32(3 * d[0]) for d in dims]),
    }
    edge_args = {"gcrn": em, "stacked": em,
                 "evolve": [f32(B, T, n, d[0]) for d in dims]}
    for family, args in cases.items():
        for edges in (False, True):
            full = args + (edge_args[family],) if edges else args
            got, want = (ops.stream_steps_batched(
                family, *full, lengths=lengths, device="cuda", force_ref=fr)
                for fr in (False, True))
            err = max_err(got, want)
            log(f"{family}_engine: n=37 H/D=24/16 ragged edges={edges} "
                f"max_abs_err={err:.3e} (tol {TOL_KERNEL})")
            check(np.isfinite(err) and err <= TOL_KERNEL, family)
    # TGN and the static GCN: odd feature widths, a length-0 ragged row
    # (a dead slot for the static GCN), event times up to BC-Alpha's
    din_o, dims_o = 13, [(13, 11), (11, 7)]
    x_o = f32(B, T, n, din_o) * mask[..., None]
    ts = (rng.uniform(0.0, 137.0, (B, T, n, k)) * (coef != 0)).astype(
        np.float32)
    freq = (1.0 / 10.0 ** np.linspace(0.0, 4.0, h)).astype(np.float32)
    static = (idx[:, :1], coef[:, :1], x_o[:, :1], mask[:, :1],
              [f32(*d) for d in dims_o], [f32(d[1]) for d in dims_o])
    for family, full, lens, label in (
            ("tgn", (idx, coef, ts, x_o, ren, mask, f32(B, G, h), freq,
                     f32(din_o, h), f32(h, 3 * h), f32(h, 3 * h),
                     f32(3 * h)), [3, 0, 2], "no edge variant"),
            ("static_gcn", static, [1, 0, 1], "edge term=False"),
            ("static_gcn", static + ([f32(B, 1, n, d[0]) for d in dims_o],),
             [1, 0, 1], "edge term=True")):
        got, want = (ops.stream_steps_batched(
            family, *full, lengths=lens, device="cuda", force_ref=fr)
            for fr in (False, True))
        err = max_err(got, want)
        log(f"{ENGINE[family]}: n=37 k=5 din=13 H/D=24/13,11,7 ragged "
            f"{lens} {label} max_abs_err={err:.3e} (tol {TOL_KERNEL})")
        check(np.isfinite(err) and err <= TOL_KERNEL, family)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    g = [cu(a[0, 0]) for a in (idx, coef, eidx)]
    xs, hs, cs = cu(x[0, 0]), cu(f32(n, h)), cu(f32(n, h))
    # (label, op, arguments, the edge messages of its edge variant)
    steps = (
        ("ell_spmm d=12", ops.ell_spmm, (*g, xs), cu(em[0, 0])),
        ("ell_spmm d=24", ops.ell_spmm, (*g, hs), cu(f32(e, h))),
        ("ell_spmm (2, 3) graphs d=12", ops.ell_spmm,
         tuple(cu(a[:2]) for a in (idx, coef, eidx, x)), cu(em[:2])),
        ("gcrn_step", ops.dgnn_fused_step,
         (*g, xs, hs, cs, cu(f32(din, 4 * h)), cu(f32(h, 4 * h)),
          cu(f32(4 * h))), cu(em[0, 0])),
        ("stacked_step", ops.stacked_fused_step,
         (*g, xs, hs, cu(f32(din, 16)), cu(f32(16)), cu(f32(16, 3 * h)),
          cu(f32(h, 3 * h)), cu(f32(3 * h))), cu(em[0, 0])),
    )
    for label, fn, args, edge_msg in steps:
        for full in (args, (*args, edge_msg)):
            got, want = fn(*full), fn(*full, force_ref=True)
            err = max_err(got, want)
            log(f"{label}: n=37 edges={len(full) > len(args)} "
                f"max_abs_err={err:.3e} (tol {TOL_KERNEL})")
            check(np.isfinite(err) and err <= TOL_KERNEL, label)


# ---------------------------------------------------------- main path ----

def per_step_levels(cfg):
    return [lv for lv in api.FAMILY_LEVELS[api.family_for(cfg)] if lv != "v3"]


def main_paths():
    """(cfg, level, impl) of every main path: every level through the
    session, then the per-step levels with the ELL SpMM (impl "pallas";
    TGN has no GCN, so none of its levels reaches it)."""
    for cfg in CONFIGS:
        for level in api.FAMILY_LEVELS[api.family_for(cfg)]:
            yield cfg, level, "session"
    for cfg in CONFIGS:
        if cfg is TGN:
            continue
        for level in per_step_levels(cfg):
            yield cfg, level, "pallas"



def expected_kernels(cfg, level, impl) -> set:
    """The kernels a main path must launch (TGN and the static GCN launch
    none at baseline through the session: plain PyTorch steps)."""
    family = api.family_for(cfg)
    if level == "v3":
        return {ENGINE[family]}
    names = set()
    if level == "v2":
        names.add(f"{family}_step")
    # at v2 the fused step does the message passing of the last GCN
    # layer; only the stacked family's earlier layers use the ELL SpMM
    if impl == "pallas" and not (level == "v2" and (
            family == "gcrn" or cfg.n_gnn_layers == 1)):
        names.add("ell_spmm")
    return names


def windows_for(cfg, level):
    """run_batched windows of a path's stream."""
    if cfg is TGN:
        return EVENT_V3_WINDOWS if level == "v3" else EVENT_STEP_WINDOWS
    return V3_WINDOWS if level == "v3" else STEP_WINDOWS


def out_width(cfg) -> int:
    """Width of a path's outputs: TGN's are its memory and the stacked
    family's its GRU state (cfg.hidden); the others end in a head or a last
    GCN layer of cfg.out_dim."""
    return (cfg.hidden if api.family_for(cfg) in ("stacked", "tgn")
            else cfg.out_dim)


def drive(cfg, level, impl, params, n_global, stream, np_stream, *,
          force_ref=False, reps=0):
    """One main path: a run of the whole stream, then a batched run over
    windows. Returns ((outs, state, outs_b, states_b), run ms/snapshot of
    the first run and of ``reps`` more runs of the same stream)."""
    T = stream.node_mask.shape[0]
    wins = windows_for(cfg, level)
    ms = []

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / T)
        return out

    if impl == "session":
        sess = api.BoosterSession(cfg, api.plan(cfg, level=level),
                                  n_global=n_global, params=params,
                                  device="cuda", force_ref=force_ref)
        outs = timed(lambda: sess.run(stream))
        state = sess.state
        states_b, outs_b = sess.run_batched([window(np_stream, a, b)
                                             for a, b in wins])
        for _ in range(reps):
            timed(lambda: sess.run(stream))
    else:
        model = build_model(cfg, impl="pallas", n_global=n_global)
        p = api.plan(cfg, level=level)
        state0 = model.init_state(params, mode=level)
        run = lambda: run_plan(model, params, state0, stream, p,
                               force_ref=force_ref)
        state, outs = timed(run)
        B = len(wins)
        states_b, outs_BT = run_plan_batched(
            model, params, init_states_batched(model, params, B, mode=level),
            batch_of(np_stream, wins), api.plan(cfg, level=level, batch=B),
            force_ref=force_ref)
        outs_b = list(outs_BT)
        for _ in range(reps):
            timed(run)
    torch.cuda.synchronize()
    return (outs, state, outs_b, states_b), ms


def check_path(label, cfg, level, res, ref, T):
    outs, state, outs_b, states_b = res
    wins = windows_for(cfg, level)
    width = out_width(cfg)
    check(outs.shape == (T, N_PAD, width),
          f"{label} output shape {tuple(outs.shape)}")
    check(all(o.shape[0] == b - a for o, (a, b) in zip(outs_b, wins)),
          f"{label} batched output lengths")
    check(all(bool(torch.isfinite(o).all()) for o in (outs, *outs_b)),
          f"{label} outputs finite")
    check(float(outs.abs().max()) > 0, f"{label} outputs nonzero")
    errs = {"run outs": max_err(outs, ref[0]),
            "run state": max_err(state, ref[1]),
            "batched outs": max_err(list(outs_b), list(ref[2])),
            "batched states": max_err(states_b, ref[3])}
    log(f"{label} vs force_ref: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_STREAM})")
    check(all(np.isfinite(v) and v <= TOL_STREAM for v in errs.values()),
          f"{label} vs force_ref {errs}")


def tile_probe():
    """Where a live node tile's time goes: gcrn_step at full width (n 640,
    din 64, H 128, k 27) on synthetic inputs that vary the live rows, the
    live lanes a row and the widths, timed as bare launches (us a call).
    With 5 live lanes a row and 128 live rows it matches the main path's
    shape (~107 real rows, ~5 live lanes)."""
    def inputs(live_rows=128, live_lanes=5, k=27, din=64, H=128):
        g = torch.Generator().manual_seed(SEED)
        n = N_PAD
        live_rows = min(live_rows, n)
        idx = torch.randint(0, max(live_rows, 1), (n, k), generator=g,
                            dtype=torch.int32)
        coef = torch.zeros(n, k)
        coef[:live_rows, :live_lanes] = torch.rand(live_rows, live_lanes,
                                                   generator=g) + 0.1
        dense = [torch.randn(*shape, generator=g) * 0.3 for shape in
                 ((n, din), (n, H), (n, H), (din, 4 * H), (H, 4 * H))]
        return [t.cuda() for t in (idx, coef, torch.zeros_like(idx), *dense,
                                   torch.zeros(4 * H))]

    cases = (("128 live rows, 5 of 27 lanes", {}),
             ("128 live rows, 1 of 27 lanes", dict(live_lanes=1)),
             ("128 live rows, k = 1", dict(live_lanes=1, k=1)),
             ("128 live rows, 27 of 27 lanes", dict(live_lanes=27)),
             ("32 live rows (one tile), 5 lanes", dict(live_rows=32)),
             ("640 live rows, 5 lanes", dict(live_rows=640)),
             ("no live row (bias only)", dict(live_rows=0)),
             ("128 live rows, din 32, H 64", dict(din=32, H=64)))
    for label, kw in cases:
        p = engine.prepare("gcrn_step", *inputs(**kw))
        us = cuda_ms(lambda: [engine.launch(p) for _ in range(100)],
                     reps=3) * 10
        log(f"tile probe gcrn_step: {label}: {us:.1f} us a call")


def busy_share(cfg, level, params, n_global, stream):
    """(wall ms, device ms) of one session ``run`` of the whole stream under
    torch.profiler: the device time is the kernels' summed self time. The
    profiler's own host cost lengthens the wall time, so 1 - device / wall
    overstates the idle share."""
    from torch.profiler import ProfilerActivity, profile

    sess = api.BoosterSession(cfg, api.plan(cfg, level=level),
                              n_global=n_global, params=params,
                              device="cuda")
    sess.run(stream)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run(stream)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, device


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # phase 2: build
    t0 = time.time()
    paths = engine.build()
    log(f"build: {time.time() - t0:.1f} s -> "
        + ", ".join(str(p.relative_to(ROOT)) if p.is_relative_to(ROOT)
                    else str(p) for p in paths.values()))
    for name, text in engine.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    np_stream, n_global = bc_alpha()
    stream = np_stream.to("cuda")
    T = stream.node_mask.shape[0]
    np_events = bc_alpha_events()
    events = np_events.to("cuda")
    T_ev = events.node_mask.shape[0]
    # each path's stream: TGN's event batches, the others' snapshots
    streams = {cfg.name: (events, np_events) if cfg is TGN
               else (stream, np_stream) for cfg in CONFIGS}
    gen = torch.Generator().manual_seed(SEED)
    models, params = {}, {}
    for cfg in CONFIGS:
        models[cfg.name] = build_model(cfg, n_global=n_global)
        params[cfg.name] = ops.to_device(models[cfg.name].init(gen), "cuda")

    # phase 3a: narrow widths
    t0 = time.time()
    small_shapes_check()

    # phase 3b: the stream engines at full width
    check_b = batch_of(np_stream, CHECK_WINDOWS)
    solo = batch_of(np_stream, ((0, T),))
    check_ev = batch_of(np_events, CHECK_WINDOWS)
    solo_ev = batch_of(np_events, ((0, T_ev),))
    static_dims = [(STATIC_GCN.in_dim, STATIC_GCN.hidden),
                   (STATIC_GCN.hidden, STATIC_GCN.out_dim)]
    records = []
    for cfg, name, plain, cost, (b_in, s_in), tol in (
            (GCRN_M2, "gcrn_engine", engine.gcrn_plain, gcrn_cost,
             (check_b, solo), TOL_STREAM),
            (EVOLVEGCN, "evolve_engine", engine.evolve_plain,
             lambda inp: evolve_cost(inp, layer_dims(EVOLVEGCN)),
             (check_b, solo), TOL_STREAM),
            (STACKED, "stacked_engine", engine.stacked_plain, stacked_cost,
             (check_b, solo), TOL_STREAM),
            (TGN, "tgn_engine", engine.tgn_plain, tgn_cost,
             (check_ev, solo_ev), TOL_STREAM),
            (STATIC_GCN, "static_engine", engine.static_plain,
             lambda inp: static_cost(inp, static_dims), (check_b, solo),
             TOL_KERNEL)):
        m, p = models[cfg.name], params[cfg.name]
        records.append(check_engine(
            name, getattr(engine, name), plain,
            kernel_inputs(m, p, b_in, lengths=[8, 5]),
            kernel_inputs(m, p, s_in), cost, tol))

    static_wave_probe(kernel_inputs(models[STATIC_GCN.name],
                                    params[STATIC_GCN.name], solo))

    # phase 3c: the per-step kernels on recorded main-path inputs
    with recording("gcrn_step") as g_calls:
        drive(GCRN_M2, "v2", "session", params[GCRN_M2.name], n_global,
              stream, np_stream)
    with recording("stacked_step") as s_calls:
        drive(STACKED, "v2", "session", params[STACKED.name], n_global,
              stream, np_stream)
    with recording("ell_spmm") as e_calls:
        drive(GCRN_M2, "baseline", "pallas", params[GCRN_M2.name], n_global,
              stream, np_stream)
    g_calls, s_calls = g_calls[:T], s_calls[:T]  # the solo run's steps
    e_calls = e_calls[:2 * T]
    no_edge = [c for c in e_calls if c[4] is None]
    check(len(no_edge) == T and len(e_calls) == 2 * T,
          f"ell_spmm recorded {len(e_calls)} calls, {len(no_edge)} no-edge")
    lib = [sparse_mm_inputs(c) for c in no_edge]
    lib_err = max(max_err(torch.sparse.mm(a, x), engine.ell_spmm_plain(*c))
                  for (a, x), c in zip(lib, no_edge))
    log(f"torch.sparse.mm vs plain ELL SpMM: max_abs_err={lib_err:.3e}")
    records += [
        check_step_kernel("gcrn_step", engine.gcrn_step_plain, g_calls,
                          g_calls, gcrn_step_cost),
        check_step_kernel("stacked_step", engine.stacked_step_plain, s_calls,
                          s_calls, stacked_step_cost),
        check_step_kernel("ell_spmm", engine.ell_spmm_plain, e_calls,
                          no_edge, ell_cost,
                          library=[lambda a=a, x=x: torch.sparse.mm(a, x)
                                   for a, x in lib]),
    ]
    log(f"phase 3 (kernel checks and timings): {time.time() - t0:.1f} s")

    # phase 4: the main paths, counts read around each
    t0 = time.time()
    launches = {name: 0 for name in engine.KERNELS}
    for cfg, level, impl in main_paths():
        label = f"{cfg.name} {level} {impl}"
        p = params[cfg.name]
        path_stream, path_np = streams[cfg.name]
        T_path = path_stream.node_mask.shape[0]
        engine.reset_launches()
        res, ms = drive(cfg, level, impl, p, n_global, path_stream, path_np,
                        reps=RUN_REPS)
        counts = {k: v for k, v in engine.LAUNCHES.items() if v}
        log(f"path {label}: run {float(np.median(ms[1:])):.4f} ms/snapshot "
            f"median of {RUN_REPS} (first {ms[0]:.4f}, all "
            f"{', '.join(f'{m:.4f}' for m in ms)}; T={T_path}), "
            f"launches {counts}")
        for name in expected_kernels(cfg, level, impl):
            check(counts.get(name, 0) > 0, f"{label} launched {name}")
        for name, v in counts.items():
            launches[name] += v
        engine.reset_launches()
        ref, _ = drive(cfg, level, impl, p, n_global, path_stream, path_np,
                       force_ref=True)
        check(not any(engine.LAUNCHES.values()),
              f"{label} force_ref reached a kernel")
        check_path(label, cfg, level, res, ref, T_path)
    log(f"phase 4 (main paths): {time.time() - t0:.1f} s")

    # phase 5: the device's busy share of a run, per kind of level
    for cfg, level in ((GCRN_M2, "baseline"), (GCRN_M2, "v2"),
                       (GCRN_M2, "v3"), (STACKED, "v3"), (TGN, "v3"),
                       (STATIC_GCN, "v3")):
        wall, device = busy_share(cfg, level, params[cfg.name], n_global,
                                  streams[cfg.name][0])
        share = (f"{device / wall:.3f}" if device > 0
                 else "not measured (the profiler saw no device time)")
        log(f"busy {cfg.name} {level}: run {wall:.2f} ms wall under the "
            f"profiler, {device:.2f} ms of kernels, busy share {share}")

    # phase 6: where a live node tile's time goes
    tile_probe()
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} launched on the main path")
    check({r["name"] for r in records} == set(engine.KERNELS),
          "a record for every kernel")

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
