"""Training launcher (the counterpart of ``repro.launch.train``).

Trains a registered architecture with the fault-tolerant loop, on the
card unless ``--device cpu``: its reduced config by default, the
full-size one with ``--full`` (per-layer remat on):

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --full --batch 2 --seq 2048 --attn-impl flash --steps 3

The DGNN trainer is ``examples/torch/train_evolvegcn.py`` (EvolveGCN-O on
BC-Alpha link prediction); this launcher has no DGNN mode, as the JAX
package's has none.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, list_archs, reduce_for_smoke
from repro_torch.data import synthetic_lm_batches
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import RuntimeConfig, init_params, loss_fn
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.train import TrainLoopConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full-size config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--state-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "flash"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch] if args.full else reduce_for_smoke(ARCHS[args.arch])
    rt = RuntimeConfig(tp=1, scan_layers=True, remat=args.full,
                       attn_chunk=min(2048, args.seq), moe_impl="dense",
                       loss_chunk=min(128, args.seq),
                       attn_impl=args.attn_impl)
    params = init_params(cfg, rt, torch.Generator(device=dev.type)
                         .manual_seed(0), device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"training {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step on {dev}")

    batches = synthetic_lm_batches(cfg, args.batch, args.seq, device=dev)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 10),
                      total_steps=args.steps, state_dtype=args.state_dtype)
    loop = TrainLoopConfig(total_steps=args.steps,
                           checkpoint_every=max(10, args.steps // 4),
                           checkpoint_dir=args.ckpt)
    params, res = train(lambda p, b: loss_fn(p, cfg, rt, b, device=dev),
                        params, batches, opt, loop, device=dev)
    k = max(1, len(res.losses) // 10)
    print(f"steps={res.final_step} resumed_from={res.resumed_from}")
    print(f"loss first{k}={np.mean(res.losses[:k]):.4f} "
          f"last{k}={np.mean(res.losses[-k:]):.4f}")
    print(f"mean step {np.mean(res.step_times[1:] or res.step_times)*1e3:.1f}"
          f" ms, stragglers {res.straggler_steps}")


if __name__ == "__main__":
    main()
