"""Generate tokens from any assigned architecture (reduced config) with the
batched greedy decode path, on the PyTorch port (the counterpart of
``examples/lm_generate.py``): KV caches and Mamba2 states end to end.

    PYTHONPATH=src python examples/torch/lm_generate.py --arch jamba-v0.1-52b [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import ARCHS, list_archs, reduce_for_smoke
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import RuntimeConfig, init_params
from repro_torch.serve import generate


def run(arch: str, steps: int = 16, batch: int = 2, device="cuda",
        params=None) -> torch.Tensor:
    """Greedy generation from ``arch``'s reduced config: params drawn from
    seed 0 on ``device``, or ``params`` where the caller carries them.
    Returns the (batch, steps) int32 tokens."""
    dev = resolve_device(device)
    cfg = reduce_for_smoke(ARCHS[arch])
    if not cfg.supports_decode:
        raise SystemExit(f"{arch} is encoder-only: no decode step")
    rt = RuntimeConfig(tp=1, moe_impl="dense", attn_chunk=128)
    if params is None:
        params = init_params(cfg, rt, torch.Generator(device=dev.type)
                             .manual_seed(0), device=dev)
    prompt = torch.tensor([[1, 2, 3, 4]] * batch, dtype=torch.int32,
                          device=dev)
    toks = generate(params, cfg, rt, prompt, steps=steps, skv=128,
                    device=dev)
    print(f"{arch} (reduced {cfg.param_count()/1e6:.1f}M params)")
    for b in range(batch):
        print(f"  lane {b}: {list(map(int, toks[b]))}")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.arch, args.steps, args.batch, args.device)


if __name__ == "__main__":
    main()
