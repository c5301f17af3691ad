"""Serving launcher (the counterpart of ``repro.launch.serve``).

LM mode: batched greedy generation from a registered arch (its reduced
config, as in the JAX launcher), on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --lm qwen2.5-14b --steps 16

DGNN mode (``--dgnn``, and the default without ``--lm``) needs the serve
layer, which is not ported yet (ROADMAP queue 1, the serve layer).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import (ARCHS, DATASETS, DGNN_CONFIGS, list_archs,
                                 reduce_for_smoke)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import RuntimeConfig, init_params
from repro_torch.serve import generate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dgnn", choices=sorted(DGNN_CONFIGS), default=None)
    ap.add_argument("--dataset", choices=sorted(DATASETS), default="uci")
    ap.add_argument("--mode", default=None, help="baseline|o1|v1|v2")
    ap.add_argument("--snapshots", type=int, default=32)
    ap.add_argument("--lm", choices=list_archs(), default=None)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not args.lm:
        raise NotImplementedError(
            "DGNN serving (SnapshotServer) is not ported yet (ROADMAP queue "
            "1, the serve layer); --lm runs the LM scaffold")
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


if __name__ == "__main__":
    main()
