#!/usr/bin/env python3
"""The port's device sharding across the cards of one host.

    python3 tools/sharding_multicard.py            # every card of the host
    python3 tools/sharding_multicard.py --device cpu --reduced   # rehearsal

Needs at least two cards (``chip_smoke.py`` runs one card's share: the
world-1 group). Prints the card's name and power limit first, then:

1. the sharded DGNN launch (one process, the cards as DeviceSpec(n)
   devices): for n = 2 and every card count up to the host's,
   chip_smoke's ``sharded_dgnn_check`` (each family's v3 run_batched over
   four BC-Alpha windows bit for bit the unsharded launch), then
   GCRN-M2's run_batched at B = SCALE_B (the four windows repeated) timed
   sharded and unsharded in turns (host clock around work that ends in a
   synchronize of every card; median of SAMPLES): ms and snapshots/s;
2. one process a card on NCCL (``init_process_group`` on
   tcp://localhost with a free port): ``compressed_all_reduce`` of 64 MiB
   fp32 a rank bit for bit the protocol computed locally from every
   rank's tensor, ``bf16_all_reduce`` within the rounding of its sums,
   each timed (CUDA events) beside a plain fp32 ``all_reduce``; the GPipe
   ``pipeline`` over one stage a card against ``reference_stack``
   (<= 1e-5); granite-moe-3b-a800m at full width and depth with
   ``moe_impl="ep"`` on a (data 1, model n) mesh: each MoE sublayer,
   teacher-forced on the dense prefill's inputs, at a capacity that drops
   nothing (cf_send n, cf_local the experts a rank) within 2e-2 of the
   dense path and the argmax of that prefill the dense one's; then at the
   default cf 1.25 / 1.25 the ep prefill's ms (median of 3), peak memory
   over the weights and dropped copies a layer (summed over the ranks)
   beside the dense prefill on one card;
3. tensor parallelism, one process a card on NCCL for each width n in
   (2, 4) the host has: Qwen2.5-14B at full width and depth (bf16
   weights from the seed, the same on every card) with its parameters
   distributed by ``param_axes`` over a (data 1, model n) mesh: the flash
   prefill's (B 2 x S 2048) logits within ``chip_smoke.TOL_DRIFT`` of one
   card's unsharded prefill (rank 0) and the argmax equal; its ms (median
   of 3 after a warm call); the collectives of one prefill on rank 0
   (``roofline.CostCounter``) beside the port's dry run's count for the
   same mesh (``launch.dryrun --mesh 1xn``, a process on the CPU).

Every check that fails ends the run with a non-zero exit. ``--device
cpu`` runs part 2 on ``gloo`` ranks of this CPU (with ``--reduced``, the
reduced granite and short sequences) and not part 1.
"""
import argparse
import dataclasses
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import ARCHS, reduce_for_smoke  # noqa: E402
from repro_torch.configs.dgnn import GCRN_M2, TGN  # noqa: E402
from repro_torch.core.dataflow import (build_model,  # noqa: E402
                                       init_states_batched)
from repro_torch.graph.padding import stack_ragged  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.api import (distribute,  # noqa: E402
                                         sharding_ctx, tree_map2,
                                         tree_shardings)
from repro_torch.distributed.pipeline import (pipeline,  # noqa: E402
                                              reference_stack)
from repro_torch.kernels import engine, ops  # noqa: E402
from repro_torch.launch.mesh import DeviceSpec  # noqa: E402
from repro_torch.models import (RuntimeConfig, init_params,  # noqa: E402
                                param_axes, prefill_step)
from repro_torch.roofline import CostCounter  # noqa: E402
from repro_torch.nn import moe as moe_mod  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

# GCRN-M2's timed batch: the four v3 windows repeated, enough streams to
# fill several waves of clusters on one card
SCALE_B = 64
SAMPLES = 5
TIMEOUT_S = 900


def log(*a):
    print(*a, flush=True)


def all_synced(n: int) -> None:
    for i in range(n):
        torch.cuda.synchronize(i)


def dgnn_part(card: str, n_cards: int) -> None:
    """The sharded DGNN launch on DeviceSpec(n) cards."""
    t0 = time.time()
    engine.build()
    np_stream, n_global = cs.bc_alpha()
    np_events = cs.bc_alpha_events()
    streams = {cfg.name: (None, np_events if cfg is TGN else np_stream)
               for cfg in cs.CONFIGS}
    gen = torch.Generator().manual_seed(cs.SEED)
    params = {cfg.name: ops.to_device(
        build_model(cfg, n_global=n_global).init(gen), "cuda")
        for cfg in cs.CONFIGS}
    counts = sorted({2, n_cards})
    for n in counts:
        cs.SHARD_N = n
        cs.sharded_dgnn_check(params, streams, n_global, card)
    # the launch alone: run_arrays on the batch's packed arguments, already
    # on the first card (a sharded launch copies its slices to the others)
    wins = [w for _ in range(SCALE_B // len(cs.V3_WINDOWS))
            for w in cs.V3_WINDOWS]
    total = sum(b - a for a, b in wins)
    model = build_model(GCRN_M2, n_global=n_global)
    p = params[GCRN_M2.name]
    snaps, lens = stack_ragged([cs.window(np_stream, a, b) for a, b in wins],
                               "cuda")
    args = model.stream_args(p, init_states_batched(
        model, p, len(wins), mode="v3"), snaps)
    plans = {n: api.plan(GCRN_M2, level="v3", batch=len(wins),
                         lengths=tuple(lens), device=DeviceSpec(n_devices=n))
             for n in [1] + counts}
    run = lambda n: api.run_arrays(plans[n], *args, device="cuda")
    base = run(1)
    for n in counts:
        cs.check(cs.bitwise(run(n), base),
                 f"GCRN-M2 B={len(wins)} on {n} cards bit for bit")
    all_synced(n_cards)
    ms = {n: [] for n in plans}
    order = list(plans) + list(plans)[::-1]
    for _ in range(SAMPLES):
        for n in order:
            t1 = time.perf_counter()
            run(n)
            all_synced(n_cards)
            ms[n].append((time.perf_counter() - t1) * 1e3)
    for n, v in ms.items():
        med = float(np.median(v))
        log(f"dgnn: GCRN-M2 v3 run_arrays B={len(wins)} ({total} "
            f"snapshots, packed on the first card) on {n} card(s), bit for "
            f"bit: {med:.2f} ms median of {len(v)} (all "
            f"{', '.join(f'{x:.2f}' for x in v)}), "
            f"{total / med * 1e3:.0f} snapshots/s; on {card}")
    del args, snaps, base
    log(f"part 1 (sharded DGNN launch): {time.time() - t0:.1f} s")


# ------------------------------------------------------------ ranks ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"sharding_multicard check failed: {what}")


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def collectives(rank, world, dev, numel) -> dict:
    """compressed / bf16 all-reduce against the protocol computed locally
    from every rank's tensor (each drawn from its rank's seed)."""
    xs = [torch.randn(numel, generator=torch.Generator(device=dev.type)
                      .manual_seed(cs.SEED + 100 + r), device=dev)
          for r in range(world)]
    y, res = compression.compressed_all_reduce(xs[rank],
                                               torch.zeros_like(xs[rank]))
    scale = torch.stack([compression._absmax_scale(compression._blocks(x))
                         for x in xs]).amax(0)
    codes = [compression._quant_with_scale(x, scale) for x in xs]
    qsum = sum(q.to(torch.int32) for q, _ in codes)
    want = compression._dequant(qsum, scale, xs[rank].shape) / world
    same = torch.equal(y, want) and torch.equal(res, codes[rank][1])
    b = compression.bf16_all_reduce(xs[rank])
    rounded = [x.to(torch.bfloat16).float() for x in xs]
    bound = (world - 1) * 2.0 ** -8 * float(
        sum(r.abs() for r in rounded).max()) / world
    b_err = float((b - sum(rounded) / world).abs().max())
    _check(same, f"rank {rank}: compressed_all_reduce equals the protocol")
    _check(b_err <= bound, f"rank {rank}: bf16_all_reduce {b_err} > {bound}")
    out = {"compressed_equal": same, "bf16_err": b_err, "bf16_bound": bound}
    if dev.type == "cuda":
        zero = torch.zeros_like(xs[rank])
        plain = xs[rank].clone()
        out.update(
            compressed_ms=_events_ms(
                lambda: compression.compressed_all_reduce(xs[rank], zero), 5),
            bf16_ms=_events_ms(
                lambda: compression.bf16_all_reduce(xs[rank]), 5),
            fp32_ms=_events_ms(lambda: dist.all_reduce(plain), 5))
    return out


def pipeline_check(world, dev) -> float:
    gen = torch.Generator(device=dev.type).manual_seed(cs.SEED + 7)
    d = cs.PIPE_D
    sp = {"w": torch.randn((world, d, d), generator=gen, device=dev)
          / d ** 0.5,
          "b": torch.randn((world, d), generator=gen, device=dev) * 0.1}
    xs = torch.randn((cs.PIPE_MICRO, cs.PIPE_ROWS, d), generator=gen,
                     device=dev)
    block = lambda p, v: torch.tanh(v @ p["w"] + p["b"])
    stage = init_device_mesh(dev.type, (world,), mesh_dim_names=("stage",))
    got = pipeline(block, stage, world, cs.PIPE_MICRO)(sp, xs)
    err = float((got - reference_stack(block, sp, xs)).abs().max())
    _check(err <= cs.TOL_PIPE, f"pipeline over {world} stages: {err}")
    return err


def _timed_prefill(params, cfg, rt, tokens, dev, stats=None):
    times = []
    for i in range(4):
        st = {} if stats is not None and i == 0 else None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        if st is not None:
            with cs.recording_moe(st):
                logits = prefill_step(params, cfg, rt, {"tokens": tokens},
                                      device=dev.type)
            stats.update(st)
        else:
            logits = prefill_step(params, cfg, rt, {"tokens": tokens},
                                      device=dev.type)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    return float(np.median(times[1:])), times, logits


def _flipped_tokens(p, cfg, h, world) -> torch.Tensor:
    """(B, S) bools: the tokens whose top-k experts differ between the
    dense path's routing (all tokens in one product) and the ep path's
    (each rank's slice of the sequence in its own product)."""
    b, s, d = h.shape
    full = moe_mod._route(p["router"], h.reshape(-1, d), cfg)[1]
    sl = s // world
    local = torch.cat([moe_mod._route(
        p["router"], h[:, r * sl:(r + 1) * sl].reshape(-1, d), cfg)[1]
        .reshape(b, sl, -1) for r in range(world)], dim=1)
    return (full.reshape(b, s, -1).sort(-1).values
            != local.sort(-1).values).any(-1)


def ep_check(rank, world, dev, reduced: bool) -> dict:
    """granite with moe_impl="ep" over (data 1, model world)."""
    cfg = ARCHS[cs.EP_ARCH]
    seq = cs.LM_SEQ
    if reduced:
        cfg, seq = reduce_for_smoke(cfg), 64
    mesh = init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("data", "model"))
    # tp pads the experts to a multiple of the model axis
    dense_rt = RuntimeConfig(param_dtype="bf16", moe_impl="dense", tp=world)
    ep_rt = dataclasses.replace(dense_rt, moe_impl="ep")
    e_loc = cfg.padded_experts(world) // world
    ample = dataclasses.replace(ep_rt, moe_cf_send=float(world),
                                moe_cf_local=float(e_loc))
    params = init_params(cfg, dense_rt, torch.Generator(
        device=dev.type).manual_seed(cs.SEED), device=dev.type)
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED + 1).integers(
        0, cfg.vocab_size, (cs.LM_BATCH, seq)).astype(np.int32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    out = {}
    with sharding_ctx(mesh), torch.no_grad():
        inputs = []
        with cs.recording_moe({}, inputs):
            dense_logits = prefill_step(params, cfg, dense_rt,
                                        {"tokens": tokens}, device=dev.type)
        errs, drops, differs, flips, flip_errs = [], [], 0, [], []
        p_first, h_first = inputs[0]
        for p, h in inputs:
            # every rank holds rank 0's input: the ranks' own dense
            # prefills need not agree to the bit
            h0 = h.contiguous().clone()
            dist.broadcast(h0, 0)
            differs += int(not torch.equal(h0, h))
            h = h0
            st = {}
            ep = moe_mod.moe_block(p, cfg, h, impl="ep",
                                   cf_send=ample.moe_cf_send,
                                   cf_local=ample.moe_cf_local, stats=st)
            dense = moe_mod.moe_block(p, cfg, h, impl="dense")
            # the tokens whose experts differ between the two paths' routing
            # products (ep routes a rank's slice of the sequence: another
            # GEMM shape, another fp32 sum order, so a near tie in the top-k
            # can fall the other way); the others are held within TOL_EP
            flipped = _flipped_tokens(p, cfg, h, world)
            kept = ~flipped[..., None]
            scale = dense.float().abs().max()
            errs.append(float(((ep.float() - dense.float()).abs() * kept)
                              .max() / scale))
            flips.append(int(flipped.sum()))
            flip_errs.append(float(((ep.float() - dense.float()).abs()
                                    * ~kept).max() / scale))
            drops.append(int(sum(st["dropped"])))
        del inputs
        ample_logits = prefill_step(params, cfg, ample, {"tokens": tokens},
                                    device=dev.type)
        same_argmax = torch.equal(
            ample_logits[:, -1, :cfg.vocab_size].argmax(-1),
            dense_logits[:, -1, :cfg.vocab_size].argmax(-1))
        _check(sum(drops) == 0 and max(errs) <= cs.TOL_EP and same_argmax,
               f"rank {rank}: ep at ample capacity (drops {sum(drops)}, "
               f"errors by layer {errs}, argmax equal {same_argmax}; "
               f"{differs} layers' inputs differed from rank 0's; tokens "
               f"routed otherwise by layer {flips})")
        out.update(ample_max_err=max(errs), ample_errs=errs,
                   inputs_differed=differs, flips=flips,
                   flip_max_err=max(flip_errs),
                   ample_logits_err=cs.logits_err(ample_logits, dense_logits,
                                                  cfg.vocab_size))
        del ample_logits
        stats = {}
        ep_ms, ep_all, ep_logits = _timed_prefill(params, cfg, ep_rt,
                                                  tokens, dev, stats)
        d_ms, d_all, d_logits = _timed_prefill(params, cfg, dense_rt,
                                               tokens, dev)
        if dev.type == "cuda":
            # the MoE sublayer alone on layer 0's input, each way
            out.update(alone_ms=[_events_ms(
                lambda impl=impl: moe_mod.moe_block(
                    p_first, cfg, h_first, impl=impl,
                    cf_send=ep_rt.moe_cf_send, cf_local=ep_rt.moe_cf_local),
                5) for impl in ("ep", "dense")])
    dropped = torch.stack(stats["dropped"]).to(torch.int64)
    dist.all_reduce(dropped)
    _check(bool(torch.isfinite(ep_logits).all())
           and len(dropped) == cfg.n_layers, f"rank {rank}: ep prefill")
    peak = (torch.cuda.max_memory_allocated() - base
            if dev.type == "cuda" else 0)
    out.update(arch=cfg.name, layers=cfg.n_layers, seq=seq, ep_ms=ep_ms,
               ep_all=ep_all, dense_ms=d_ms, dense_all=d_all,
               dropped=[int(d) for d in dropped],
               copies=cs.LM_BATCH * seq * cfg.top_k, peak_gb=peak / 1e9,
               logits_err=cs.logits_err(ep_logits, d_logits, cfg.vocab_size))
    return out


def rank_main(rank, world, port, device, reduced, out_dir, numel):
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = {"collectives": collectives(rank, world, dev, numel),
               "pipeline_err": pipeline_check(world, dev),
               "ep": ep_check(rank, world, dev, reduced)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def ranks_part(world, device, reduced, card) -> None:
    t0 = time.time()
    numel = 4096 + 7 if reduced else cs.COLLECTIVE_NUMEL
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=rank_main, args=(
            r, world, port, device, reduced, out_dir, numel))
            for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        _check(not alive and codes == [0] * world,
               f"ranks exited with {codes} ({len(alive)} killed)")
        res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
               for r in range(world)]
    c, ep = res[0]["collectives"], res[0]["ep"]
    backend = "NCCL" if device == "cuda" else "gloo"
    log(f"ranks: {world} on {backend}: compressed_all_reduce of "
        f"{numel * 4 / 2 ** 20:.1f} MiB a rank bit for bit the local "
        f"protocol on every rank "
        f"{all(r['collectives']['compressed_equal'] for r in res)}; "
        f"bf16_all_reduce max err "
        f"{max(r['collectives']['bf16_err'] for r in res):.3e} (bound "
        f"{c['bf16_bound']:.3e})"
        + (f"; rank 0 ms: compressed {c['compressed_ms']:.3f}, bf16 "
           f"{c['bf16_ms']:.3f}, fp32 all_reduce {c['fp32_ms']:.3f}"
           if "fp32_ms" in c else "") + f"; on {card}")
    log(f"ranks: pipeline over {world} stages vs reference_stack, max "
        f"{max(r['pipeline_err'] for r in res):.3e} (tol {cs.TOL_PIPE})")
    log(f"ranks: {ep['arch']} ({ep['layers']} layers) ep over (data 1, "
        f"model {world}), B={cs.LM_BATCH} S={ep['seq']}: ample capacity, "
        f"the MoE sublayers teacher-forced on rank 0's inputs vs dense max "
        f"{max(r['ep']['ample_max_err'] for r in res):.3e} (tol "
        f"{cs.TOL_EP}) over the tokens both route alike; tokens routed "
        f"otherwise by layer {ep['flips']} (of {cs.LM_BATCH * ep['seq']}; "
        f"there max {ep['flip_max_err']:.3e}); layers whose inputs differed "
        f"across ranks {[r['ep']['inputs_differed'] for r in res]}; logits "
        f"{ep['ample_logits_err']:.3e}, 0 dropped; "
        f"cf 1.25 / 1.25: ep prefill {ep['ep_ms']:.2f} ms median of 3 "
        f"(rank 0; all {', '.join(f'{m:.2f}' for m in ep['ep_all'])}), "
        f"peak {ep['peak_gb']:.2f} GB over the weights, dropped copies by "
        f"layer {ep['dropped']} (of {ep['copies']} a layer); dense on "
        f"each card {ep['dense_ms']:.2f} ms (all "
        f"{', '.join(f'{m:.2f}' for m in ep['dense_all'])}); logits ep vs "
        f"dense {ep['logits_err']:.3e}"
        + (f"; layer 0's MoE sublayer alone ep / dense (rank 0, CUDA "
           f"events, mean of 5): {ep['alone_ms'][0]:.3f} / "
           f"{ep['alone_ms'][1]:.3f} ms" if "alone_ms" in ep else "")
        + f"; on {card}")
    log(f"part 2 ({world} ranks): {time.time() - t0:.1f} s")


def tp_rank_main(rank, world, port, out_dir):
    """Qwen2.5-14B's prefill over (data 1, model ``world``) on NCCL."""
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        cfg = ARCHS[cs.LM_ARCH]
        rt = dataclasses.replace(cs.LM_RT, attn_impl="flash")
        params = init_params(cfg, rt, torch.Generator(
            device="cuda").manual_seed(cs.SEED), device="cuda")
        tokens = cs.lm_tokens(cs.LM_BATCH, cs.LM_SEQ, cs.SEED + 1,
                              cfg.vocab_size)
        want = prefill_step(params, cfg, rt, {"tokens": tokens}) \
            if rank == 0 else None
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        with sharding_ctx(mesh):
            dp = tree_map2(distribute, params, tree_shardings(
                params, param_axes(cfg, rt), mesh))
            del params
            torch.cuda.empty_cache()
            counter = CostCounter(device="cuda")
            with counter:
                got = prefill_step(dp, cfg, rt, {"tokens": tokens})
            full = got.full_tensor()
            ms, times, _ = _timed_prefill(dp, cfg, rt, tokens, dev)
        out = {"ms": ms, "all": times,
               "coll_bytes": counter.collectives.bytes_by_op,
               "coll_count": counter.collectives.count_by_op,
               "placements": str(got.placements)}
        if rank == 0:
            V = cfg.vocab_size
            out["err"] = cs.logits_err(full, want, V)
            out["argmax_equal"] = bool(torch.equal(
                full[..., :V].argmax(-1), want[..., :V].argmax(-1)))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"tp{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_dryrun(world: int) -> dict:
    """The port's dry run of the same prefill on a fake (1, world) mesh."""
    import subprocess

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rec.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="")
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cs.LM_ARCH, "--shape", "prefill_32k", "--mesh", f"1x{world}",
             "--batch", str(cs.LM_BATCH), "--seq", str(cs.LM_SEQ),
             "--overrides", json.dumps({"rt": {
                 "attn_impl": "flash", "param_dtype": "bf16", "tp": 1}}),
             "--out", path], env=env, capture_output=True, text=True,
            timeout=600)
        _check(run.returncode == 0, f"dry run 1x{world}: {run.stdout[-2000:]}"
               f"{run.stderr[-2000:]}")
        return json.load(open(path))


def tp_part(card: str, n_cards: int) -> None:
    for world in (2, 4):
        if world > n_cards:
            continue
        t0 = time.time()
        with tempfile.TemporaryDirectory() as out_dir:
            ctx = mp.get_context("spawn")
            port = _free_port()
            procs = [ctx.Process(target=tp_rank_main,
                                 args=(r, world, port, out_dir))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(TIMEOUT_S)
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join(10)
            codes = [p.exitcode for p in procs]
            _check(not alive and codes == [0] * world,
                   f"tp ranks exited with {codes} ({len(alive)} killed)")
            res = [json.load(open(os.path.join(out_dir, f"tp{r}.json")))
                   for r in range(world)]
        rec = tp_dryrun(world)
        r0 = res[0]
        log(f"tp: {cs.LM_ARCH} prefill B={cs.LM_BATCH} S={cs.LM_SEQ} flash "
            f"over (data 1, model {world}) on NCCL: logits vs one card "
            f"{r0['err']:.3e} (tol {cs.TOL_DRIFT}), argmax equal "
            f"{r0['argmax_equal']}, placements {r0['placements']}; "
            f"{r0['ms']:.2f} ms median of 3 (rank 0; all "
            f"{', '.join(f'{m:.2f}' for m in r0['all'])}; every rank "
            f"{[round(r['ms'], 2) for r in res]}); rank 0's collectives "
            f"{r0['coll_count']} {r0['coll_bytes']} bytes; the dry run's "
            f"for 1x{world} {rec['collectives']['count_by_op']} "
            f"{rec['collectives']['bytes_by_op']} bytes (t_bound "
            f"{max(rec['roofline']['t_compute'], rec['roofline']['t_memory'], rec['roofline']['t_collective']) * 1e3:.3f}"
            f" ms, {rec['roofline']['bottleneck']}); {time.time() - t0:.1f}"
            f" s; on {card}")
        _check(r0["err"] <= cs.TOL_DRIFT and r0["argmax_equal"],
               f"tp prefill over {world} cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced granite and S 64 (rehearsal)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of part 2 (default: the host's cards; "
                         "4 on the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("sharding_multicard: needs two or more CUDA cards",
                  file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        card = cs.smi()
        n = torch.cuda.device_count()
        log(f"{card}; {n} cards; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        dgnn_part(card, n)
        torch.cuda.empty_cache()
        ranks_part(args.world or n, "cuda", args.reduced, card)
        tp_part(card, n)
    else:
        ranks_part(args.world or 4, "cpu", args.reduced, "the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
