#!/usr/bin/env python3
"""One LM's training step on one CUDA card: ms a step, its peak memory,
and where the bytes live at that peak were allocated.

    python3 tools/train_step_memory.py [--arch mamba2-2.7b] [--src DIR]

Builds ``--arch`` at full width and depth with fp32 weights drawn on the
card from seed 0 (remat, the dense MoE, flash attention), runs ``train``
for ``--steps`` steps of BATCH x SEQ synthetic tokens with AdamW's fp32
moments, as ``chip_smoke.py``'s path (c2) does, and prints
ms a step (host clock to a sync, median) and torch.cuda.max_memory_allocated
over the loop. Then one more step on a fresh optimizer state runs under
the allocator's history (``torch.cuda.memory._record_memory_history``,
Python stacks at each allocation): the bytes live at that step's peak,
grouped by the innermost frame of ``repro_torch`` that allocated them
(those allocated before the step counted as one group), the frames of
the allocation that reached the peak, and the step's blocks live there
by size (autograd's backward allocates with no Python frame: a block's
size names the tensor).

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one copy of this script measures two
trees: unpack the other under a git-ignored directory and run both in one
call, in turns (parent, change, change, parent). Prints the card's name
and power limit first; needs a card.
"""
import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
BATCH, SEQ = 2, 2048
TOP = 16
GB = 1e9


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def frame_key(frames) -> str:
    """An allocation's group: its innermost ``repro_torch`` frame
    (file:line function), else its innermost frame, else none (an
    allocation from autograd's engine outside a recompute)."""
    for f in frames:
        path = f["filename"]
        if "repro_torch" in path:
            rel = path[path.rindex("repro_torch"):]
            return f"{rel}:{f['line']} {f['name']}"
    if frames:
        f = frames[0]
        return f"{f['filename']}:{f['line']} {f['name']}"
    return "(no Python frame: autograd's backward)"


def peak_live(trace, base: int):
    """Replay one device's allocator trace (``_snapshot()['device_traces']``
    entries: alloc / free_completed with addr, size, frames) from ``base``
    bytes live at its start. Returns (peak bytes, {group: bytes live at the
    peak}, {(group, block bytes): blocks of that size live at the peak},
    the peak allocation's frames); blocks allocated before the trace and
    freed in it leave the group "(before the step)"."""
    cur, best, at = base, base, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > best:
                best, at = cur, i
        elif e["action"] == "free_completed":
            cur -= e["size"]
    groups = collections.Counter({"(before the step)": base})
    blocks = collections.Counter()
    owner = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            owner[e["addr"]] = (e["size"], frame_key(e.get("frames", [])))
        elif e["action"] == "free_completed":
            if e["addr"] in owner:
                owner.pop(e["addr"])
            else:
                groups["(before the step)"] -= e["size"]
    for size, key in owner.values():
        groups[key] += size
        blocks[key, size] += 1
    frames = trace[at].get("frames", []) if at >= 0 else []
    return best, dict(groups), dict(blocks), frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_memory: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import ARCHS
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import RuntimeConfig, init_params, loss_fn
    from repro_torch.optim import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.train import TrainLoopConfig, make_train_step, train
    import repro_torch

    print(smi(), flush=True)
    card = f"{torch.cuda.get_device_name(0)}, {smi().split(',')[-1].strip()}"
    cfg = ARCHS[args.arch]
    rt = RuntimeConfig(remat=True, moe_impl="dense", attn_impl="flash")
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
    tag = f"{args.arch} from {Path(repro_torch.__file__).parents[1]}"
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, rt, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    n = sum(t.numel() for t in tree_leaves(params))
    loss = lambda p, b: loss_fn(p, cfg, rt, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, res = train(loss, params, synthetic_lm_batches(
        cfg, BATCH, SEQ, seed=SEED, device="cuda"), opt,
        TrainLoopConfig(total_steps=args.steps))
    ms = [t * 1e3 for t in res.step_times]
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: {n / 1e9:.3f} B params ({4 * n / GB:.2f} GB fp32); "
          f"{args.steps} steps of {BATCH} x {SEQ} in "
          f"{time.time() - t0:.1f} s, losses {res.losses}; "
          f"{float(np.median(ms)):.1f} ms a step median (all "
          f"{', '.join(f'{m:.1f}' for m in ms)}); peak {peak / GB:.2f} GB "
          f"(memory_allocated at the start {base / GB:.2f} GB); on {card}",
          flush=True)

    batch = next(synthetic_lm_batches(cfg, BATCH, SEQ,
                                      seed=SEED + 1, device="cuda"))
    opt_state = init_opt_state(params, opt)
    step = make_train_step(loss, opt)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python")
    try:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    step_peak = torch.cuda.max_memory_allocated()
    trace = snap["device_traces"][0]
    best, groups, blocks, frames = peak_live(trace, start)
    print(f"{tag}: recorded step, {len(trace)} allocator events; "
          f"memory_allocated at its start {start / GB:.2f} GB (weights, "
          f"AdamW moments, batch), peak {step_peak / GB:.2f} GB "
          f"(max_memory_allocated), the replayed trace's peak "
          f"{best / GB:.2f} GB; at that peak, by allocating frame:",
          flush=True)
    for key, size in sorted(groups.items(), key=lambda kv: -kv[1])[
            :TOP]:
        print(f"  {size / GB:8.3f} GB  {key}", flush=True)
    rest = sum(sorted(groups.values(), reverse=True)[TOP:])
    print(f"  {rest / GB:8.3f} GB  ({max(len(groups) - TOP, 0)} other "
          f"groups)", flush=True)
    print("  the allocation that reached the peak: " + (" <- ".join(
        frame_key([f]) for f in frames[:8]) or frame_key([])), flush=True)
    print("  the step's blocks live at that peak, by size x count:",
          flush=True)
    for (key, size), count in sorted(blocks.items(), key=lambda kv: (
            -kv[0][1] * kv[1]))[:TOP]:
        print(f"  {size * count / GB:8.3f} GB  {size / GB:.4f} GB x {count}"
              f"  {key}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
