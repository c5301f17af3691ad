#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: card name and power limit, torch / CUDA versions, TF32 off;
  2. build both stream-engine kernels from src/repro_torch/kernels/csrc;
  3. per kernel: hold it against its plain PyTorch version on the card at
     narrow widths with partial node tiles (<= 1e-4), and at full width
     (BC-Alpha, n_pad 640, G 3468): a T = 8, B = 2 ragged case
     with edges (max abs error <= 1e-4: fp32 with TF32 off, only the order
     of summation differs) and the main path's own shapes (all 137 steps,
     <= 1e-3: the recurrence compounds sum-order differences); time both
     with CUDA events beside the kernel's bound;
  4. main path: BoosterSession.run for GCRN-M2 and EvolveGCN-O at level v3
     on the whole BC-Alpha stream, then run_batched on four ragged windows,
     each held against the session's force-ref run on the card (<= 1e-3),
     with launch counts that must be > 0.
Prints a {"kernels": [...]} line and, last, the device line.

Imports nothing of the JAX package.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs.dgnn import BC_ALPHA, EVOLVEGCN, GCRN_M2  # noqa: E402
from repro_torch.core.dataflow import (build_model, init_states_batched,  # noqa: E402
                                       stack_time)
from repro_torch.core.evolvegcn import layer_dims  # noqa: E402
from repro_torch.graph import (generate_temporal_graph, max_in_degree,  # noqa: E402
                               pad_snapshot, renumber_and_normalize,
                               slice_snapshots)
from repro_torch.graph.padding import PaddedSnapshot, stack_ragged  # noqa: E402
from repro_torch.kernels import engine, ops  # noqa: E402

# published H100 SXM peaks: fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
TOL_KERNEL = 1e-4
TOL_STREAM = 1e-3
N_PAD = 640
SEED = 0
WINDOWS = ((0, 137), (0, 100), (40, 137), (0, 64))


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


def max_err(a, b) -> float:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


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


def window(s: PaddedSnapshot, a: int, b: int) -> PaddedSnapshot:
    return PaddedSnapshot(**{k: v[a:b] for k, v in vars(s).items()})


def batch_of(s: PaddedSnapshot, wins) -> PaddedSnapshot:
    """B windows of one stream stacked to the longest (ragged)."""
    return stack_ragged([window(s, a, b) for a, b in wins], "cuda")[0]


# ------------------------------------------------------------ kernels ----

def kernel_inputs(model, params, snaps, lengths=None):
    """The kernel wrapper's inputs for a (B, T, ...) batch: the model's
    stream arguments, packed by kernels/ops.py as the main path packs them."""
    B = snaps.node_mask.shape[0]
    state = init_states_batched(model, params, B)
    return ops.pack(model.stream_family,
                    *model.stream_args(params, state, snaps), lengths=lengths)


def gcrn_cost(inp):
    """(flop, bytes) the GCRN kernel's function needs on these inputs: the
    ELL lanes, x row and row id of each real row (mask != 0), the edge
    messages its live lanes read, the weights, the stores in and out, the
    per-step h output, and the gather / scatter of each real row's h and c."""
    idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, em = inp
    B, T, n, k = idx.shape
    din, h = x.shape[-1], h0.shape[-1]
    rows = float((mask != 0).sum())
    live = coef != 0
    lanes = float(live.sum())
    flops = 2 * rows * (din + h) * 4 * h + 2 * lanes * (din + h)
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    if em is not None:
        step = torch.arange(B * T, device=idx.device).view(B, T, 1, 1)
        edges = torch.unique((step * em.shape[2] + eidx)[live]).numel()
        byts += edges * din * 4
    byts += nbytes(wx, wh, b) + 2 * nbytes(h0, c0) + B * T * n * h * 4
    byts += rows * 2 * h * 4 * 2
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


def check_kernel(name, kernel, plain, check_inp, main_inp, cost):
    """Kernel vs plain version on the card; returns the JSON record."""
    got, want = kernel(*check_inp), plain(*check_inp)
    torch.cuda.synchronize()
    err_small = max_err(got, want)
    log(f"{name}: T=8 B=2 ragged max_abs_err={err_small:.3e} "
        f"(tol {TOL_KERNEL})")
    check(np.isfinite(err_small) and err_small <= TOL_KERNEL, name)
    got, want = kernel(*main_inp), plain(*main_inp)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"{name}: main-path shapes max_abs_err={err:.3e} (tol {TOL_STREAM})")
    check(np.isfinite(err) and err <= TOL_STREAM, name)
    ms = cuda_ms(lambda: kernel(*main_inp), reps=5)
    plain_ms = cuda_ms(lambda: plain(*main_inp), reps=2)
    flops, byts = cost(main_inp)
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, byts / PEAK_BYTES * 1e3
    log(f"{name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
        f"bound {max(t_ops, t_bytes):.4f} ms ({flops:.3e} flop, "
        f"{byts:.3e} B)")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "err_t8_b2": err_small}


def small_shapes_check():
    """Both kernels through ops at narrow widths and a node count that
    leaves a partial 32-row tile and a partial 8-row micro-tile (n = 37,
    H = 24, D = 16), ragged, random data from the seed; each against its
    force-ref run (<= 1e-4)."""
    rng = np.random.default_rng(SEED)
    B, T, n, k, din, h, G, e = 3, 3, 37, 5, 12, 24, 90, 120
    nr = rng.integers(10, n + 1, (B, T))
    rows = np.arange(n) < nr[..., None]
    idx = (rng.random((B, T, n, k)) * nr[..., None, None]).astype(np.int32)
    coef = (rng.random((B, T, n, k)) * (rng.random((B, T, n, k)) > 0.4)
            * rows[..., None]).astype(np.float32)
    ren = np.where(rows, np.stack([[rng.permutation(G)[:n] for _ in range(T)]
                                   for _ in range(B)]), -1).astype(np.int32)
    mask = rows.astype(np.float32)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    lengths = [3, 1, 2]
    gcrn = (idx, coef, rng.integers(0, e, (B, T, n, k)).astype(np.int32),
            f32(B, T, n, din) * mask[..., None], ren, mask, f32(B, G, h),
            f32(B, G, h), f32(din, 4 * h), f32(h, 4 * h), f32(4 * h),
            f32(B, T, e, din))
    dims = [(din, 16), (16, 8)]
    evolve = (idx, coef, f32(B, T, n, din) * mask[..., None], mask,
              np.ones((B, T), np.int32), [f32(B, *d) for d in dims],
              [f32(d[1]) for d in dims], [f32(d[0], 3 * d[0]) for d in dims],
              [f32(d[0], 3 * d[0]) for d in dims], [f32(3 * d[0]) for d in dims],
              [f32(B, T, n, d[0]) for d in dims])
    for family, args in (("gcrn", gcrn), ("evolve", evolve)):
        got, want = (ops.stream_steps_batched(
            family, *args, lengths=lengths, device="cuda", force_ref=fr)
            for fr in (False, True))
        flat = lambda r: [x for y in r for x in
                          (y if isinstance(y, (tuple, list)) else (y,))]
        err = max_err(flat(got), flat(want))
        log(f"{family}_engine: n=37 H/D=24/16 ragged max_abs_err={err:.3e} "
            f"(tol {TOL_KERNEL})")
        check(np.isfinite(err) and err <= TOL_KERNEL, family)


# ---------------------------------------------------------- main path ----

def drive(cfg, params, n_global, stream, streams):
    """run + run_batched through the sessions; force-ref runs afterwards.
    Returns the kernel-path results, their launches and timings."""
    p = api.plan(cfg, level="v3")
    sess = api.BoosterSession(cfg, p, n_global=n_global, params=params,
                              device="cuda")
    T = stream.node_mask.shape[0]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    outs = sess.run(stream)
    end.record()
    state = sess.state
    states_b, outs_b = sess.run_batched(streams)
    torch.cuda.synchronize()
    ms_snap = start.elapsed_time(end) / T
    peak = torch.cuda.max_memory_allocated()
    return (outs, state, outs_b, states_b), ms_snap, peak


def force_ref(cfg, params, n_global, stream, streams):
    p = api.plan(cfg, level="v3")
    sess = api.BoosterSession(cfg, p, n_global=n_global, params=params,
                              device="cuda", force_ref=True)
    outs = sess.run(stream)
    states_b, outs_b = sess.run_batched(streams)
    return outs, sess.state, outs_b, states_b


def state_err(a, b) -> float:
    if "weights" in a:
        return max_err(a["weights"], b["weights"])
    return max(max_err(a["h"], b["h"]), max_err(a["c"], b["c"]))


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
    gen = torch.Generator().manual_seed(SEED)
    g_model, e_model = build_model(GCRN_M2, n_global), build_model(EVOLVEGCN)
    g_params = ops.to_device(g_model.init(gen), "cuda")
    e_params = ops.to_device(e_model.init(gen), "cuda")

    # phase 3: each kernel against its plain version
    check_b = batch_of(stream, ((0, 8), (40, 48)))
    solo = batch_of(stream, ((0, T),))
    records = [
        check_kernel("gcrn_engine", engine.gcrn_engine, engine.gcrn_plain,
                     kernel_inputs(g_model, g_params, check_b, lengths=[8, 5]),
                     kernel_inputs(g_model, g_params, solo), gcrn_cost),
        check_kernel("evolve_engine", engine.evolve_engine,
                     engine.evolve_plain,
                     kernel_inputs(e_model, e_params, check_b, lengths=[8, 5]),
                     kernel_inputs(e_model, e_params, solo),
                     lambda inp: evolve_cost(inp, layer_dims(EVOLVEGCN))),
    ]
    small_shapes_check()
    records[0]["replaces"] = "src/repro/kernels/stream_fused.py:833"
    records[1]["replaces"] = "src/repro/kernels/stream_fused.py:1191"

    # phase 4: the main path through the sessions
    streams = [window(np_stream, a, b) for a, b in WINDOWS]
    engine.reset_launches()
    g_res, g_ms, g_peak = drive(GCRN_M2, g_params, n_global, stream, streams)
    e_res, e_ms, e_peak = drive(EVOLVEGCN, e_params, n_global, stream,
                                streams)
    launches = dict(engine.LAUNCHES)
    log(f"main path launches: {launches}")
    for name, ms, peak in (("gcrn-m2", g_ms, g_peak),
                           ("evolvegcn", e_ms, e_peak)):
        log(f"{name}: run {ms:.4f} ms/snapshot (T={T}), peak device memory "
            f"{peak / 2**20:.1f} MiB")
    for cfg, res, params in ((GCRN_M2, g_res, g_params),
                             (EVOLVEGCN, e_res, e_params)):
        outs, state, outs_b, states_b = res
        ref = force_ref(cfg, params, n_global, stream, streams)
        check(outs.shape == (T, N_PAD, cfg.out_dim),
              f"{cfg.name} output shape {tuple(outs.shape)}")
        check(all(o.shape[0] == b - a for o, (a, b) in zip(outs_b, WINDOWS)),
              f"{cfg.name} batched output lengths")
        check(all(bool(torch.isfinite(o).all()) for o in (outs, *outs_b)),
              f"{cfg.name} outputs finite")
        check(float(outs.abs().max()) > 0, f"{cfg.name} outputs nonzero")
        errs = {"run outs": max_err(outs, ref[0]),
                "run state": state_err(state, ref[1]),
                "batched outs": max(max_err(o, r)
                                    for o, r in zip(outs_b, ref[2])),
                "batched states": state_err(states_b, ref[3])}
        log(f"{cfg.name} vs force_ref: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {TOL_STREAM})")
        check(all(np.isfinite(v) and v <= TOL_STREAM for v in errs.values()),
              f"{cfg.name} vs force_ref {errs}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} launched on the main path")

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
