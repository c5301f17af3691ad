"""Synthetic LM data (the counterpart of ``repro.data.tokens``): offline
and deterministic.

Zipf-distributed token streams with bigram structure so the loss has
something to learn, and shifted next-token targets. The numpy generator is
a copy of the JAX package's, so the same seed gives the same tokens bit
for bit; the batches are placed on ``device`` (the card unless the caller
asks for the CPU) where the JAX package shards them over its mesh.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device


def synthetic_lm_batches(cfg: ModelConfig, batch: int, seq: int,
                         seed: int = 0, device="cuda") -> Iterator[dict]:
    """Yields {"tokens": (B, S) int32, "targets": (B, S) int32} (or
    {"embeds": (B, S, D) float32, "targets"} for embeddings-input archs)
    forever, as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    # a fixed random bigram table gives learnable structure
    fanout = 32
    table = rng.integers(0, vocab, size=(vocab, fanout))
    while True:
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.zipf(1.3, size=batch) % vocab
        choice = rng.integers(0, fanout, size=(batch, seq))
        noise = rng.random((batch, seq)) < 0.1
        rand_tok = rng.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            nxt = table[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
        if cfg.input_mode == "embeddings":
            emb = rng.normal(0, 1, (batch, seq, cfg.d_model)).astype(
                np.float32)
            out = {"embeds": emb, "targets": out["targets"]}
        yield {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
