#!/usr/bin/env python3
"""Weigh the dK / dV pass's kv tile on one CUDA card: 128 kv rows a CTA
(two consumer warpgroups, one CTA an SM; the default) against 64 (one
consumer warpgroup, two CTAs an SM, twice the CTAs).

    python3 tools/flash_bwd_kv_tile.py

Builds csrc/flash_attention_bwd.cu twice (the second with
-DFLASH_BWD_DKV_WARPGROUPS=1), holds both flash_bwd_dkv launches against
the plain version at Qwen2.5-14B's layer shape (q (80, 2048, 128), k / v
(16, 2048, 128), group 5) and phi3-mini-3.8b's training shape (q / k / v
(64, 2048, 96), group 1), bf16, causal, and times them in turns (CUDA
events, median of 9 samples of 10 calls, two rounds), each with its share
of the bound. Prints the card's name and power limit first.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import engine  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

VARIANT = "-DFLASH_BWD_DKV_WARPGROUPS=1"
SHAPES = (("Qwen2.5-14B layer shape", 80, 128, 5),
          ("phi3-mini-3.8b training shape", 64, 96, 1))
DEFAULT_FLAGS = engine.NVCC_FLAGS


def libraries() -> dict:
    """{kv rows a CTA: the loaded backward library}: the default build,
    then the one-warpgroup build (the flags are part of the library's
    digest, so it is a file of its own)."""
    libs = {}
    try:
        for rows, flags in ((128, ()), (64, (VARIANT,))):
            engine.NVCC_FLAGS = DEFAULT_FLAGS + flags
            for name in ("flash_bwd_dkv", "flash_bwd_dq"):
                engine._LIBS.pop(name, None)
            libs[rows] = engine._library("flash_bwd_dkv")
            cfg = engine.library_flash_bwd_config(80, 2048, 5, "dkv")
            print(f"{rows}-row kv tile: launch {cfg}", flush=True)
            if cfg["kv_rows"] != rows:
                raise RuntimeError(f"built {cfg['kv_rows']}-row kv tiles, "
                                   f"expected {rows}")
    finally:
        engine.NVCC_FLAGS = DEFAULT_FLAGS
    return libs


def use(lib) -> None:
    engine._LIBS["flash_bwd_dkv"] = engine._LIBS["flash_bwd_dq"] = lib


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_kv_tile: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    engine.build(("flash_fwd",))
    libs = libraries()
    for label, bh, d, group in SHAPES:
        args = cs.flash_bwd_inputs(cs.SEED + 5, bh, cs.LM_SEQ, d, group,
                                   torch.bfloat16, True)
        want = fa.flash_bwd_dkv_plain(*args)
        flops, _ = cs.flash_bwd_cost(args[0], args[1], True, 8)
        bound_ms = flops / cs.PEAK_BF16 * 1e3
        calls = []
        for rows, lib in libs.items():
            use(lib)
            got = fa.flash_bwd_dkv(*args)
            rel = max(float((g.float() - w.float()).abs().max()
                            / w.float().abs().max())
                      for g, w in zip(got, want))
            print(f"{label}: {rows}-row kv tile max |diff| / max |plain| "
                  f"{rel:.3e}", flush=True)
            if not rel <= cs.TOL_FLASH_BWD[torch.bfloat16]:
                raise RuntimeError(f"{label}: the {rows}-row kv tile is "
                                   f"{rel:.3e} from the plain version")
            calls.append(lambda lib=lib: (use(lib), fa.flash_bwd_dkv(*args)))
        for rnd in range(2):
            ms = cs.interleaved_ms(calls, cs.FLASH_CALLS, cs.FLASH_SAMPLES)
            print(f"{label} round {rnd}: " + ", ".join(
                f"{rows}-row kv tile {t:.4f} ms ({bound_ms / t:.3f} of the "
                f"bound)" for rows, t in zip(libs, ms))
                + f"; 64 / 128 {ms[1] / ms[0]:.3f}", flush=True)
    use(libs[128])
    return 0


if __name__ == "__main__":
    sys.exit(main())
