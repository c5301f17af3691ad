"""Serving launcher (the counterpart of ``repro.launch.serve``).

LM mode: batched greedy generation from a registered arch (its reduced
config, as in the JAX launcher), on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --lm qwen2.5-14b --steps 16

DGNN mode (``--dgnn``, and the default without ``--lm``): stream synthetic
BC-Alpha / UCI snapshots through the snapshot server (serve/engine.py, the
host/device task split) at the config's level or ``--mode``:

  PYTHONPATH=src python -m repro_torch.launch.serve --dgnn gcrn-m2 --dataset uci
"""
from __future__ import annotations

import argparse

import torch

import numpy as np

from repro_torch import api
from repro_torch.configs import (ARCHS, DATASETS, DGNN_CONFIGS, list_archs,
                                 reduce_for_smoke)
from repro_torch.graph import generate_temporal_graph, slice_snapshots
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import RuntimeConfig, init_params
from repro_torch.serve import generate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dgnn", choices=sorted(DGNN_CONFIGS), default=None)
    ap.add_argument("--dataset", choices=sorted(DATASETS), default="uci")
    ap.add_argument("--mode", default=None, help="baseline|o1|v1|v2|v3")
    ap.add_argument("--snapshots", type=int, default=32)
    ap.add_argument("--lm", choices=list_archs(), default=None)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not args.lm:
        serve_dgnn(args)
        return
    cfg = reduce_for_smoke(ARCHS[args.lm])
    if not cfg.supports_decode:
        raise SystemExit(f"{args.lm} is encoder-only")
    rt = RuntimeConfig(tp=1, moe_impl="dense", attn_chunk=128)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev.type).manual_seed(0)
    params = init_params(cfg, rt, gen, device=dev)
    prompt = torch.ones((args.batch, 4), dtype=torch.int32, device=dev)
    toks = generate(params, cfg, rt, prompt, steps=args.steps, skv=256,
                    device=dev)
    print(f"{args.lm}: generated {tuple(toks.shape)} tokens")
    print(toks.cpu().numpy())


def serve_dgnn(args) -> None:
    """Serve ``args.snapshots`` synthetic snapshots of ``args.dataset``
    through ``BoosterSession.serve`` on ``args.device``."""
    name = args.dgnn or "gcrn-m2"
    cfg = DGNN_CONFIGS[name]
    ds = DATASETS[args.dataset]
    tg, ft = generate_temporal_graph(ds)
    snaps = slice_snapshots(tg, 1.0)[: args.snapshots]
    dev = resolve_device(args.device)
    sess = api.BoosterSession(cfg, api.plan(cfg, level=args.mode),
                              n_global=tg.n_global_nodes, feat_table=ft,
                              gen=torch.Generator().manual_seed(0),
                              device=dev)
    outs, stats = sess.serve(snaps)
    print(f"{name} ({sess.plan.level}) on {ds.name}, {dev}: {len(outs)} "
          f"snapshots, {stats.mean_latency_ms:.3f} ms/snapshot staging + "
          f"launch, "
          f"{np.mean(stats.preprocess_ms):.3f} ms host (overlapped), "
          f"{stats.total_ms:.1f} ms total")


if __name__ == "__main__":
    main()
