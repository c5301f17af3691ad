"""LM serving: batched greedy decode against KV caches (the counterpart of
``repro.serve.lm_serve``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import RuntimeConfig, decode_step, init_caches


def make_serve_step(cfg: ModelConfig, rt: RuntimeConfig, device="cuda"):
    """Returns (params, tokens (B,1), caches) -> (next (B,1) int32, caches),
    each call under ``torch.inference_mode()``."""

    def step(params, tokens, caches):
        with torch.inference_mode():
            logits, caches = decode_step(params, cfg, rt, tokens, caches,
                                         device=device)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return nxt[:, None], caches

    return step


def generate(params, cfg: ModelConfig, rt: RuntimeConfig,
             prompt: torch.Tensor, steps: int, skv: int, device="cuda"):
    """Greedy generation: feeds the prompt token by token, then samples.

    prompt: (B, P) int32 on ``device``. Returns (B, steps) int32. A cache
    of ``skv`` positions holds P + steps - 1 tokens; a shorter one raises
    ValueError when it fills (the JAX package would overwrite its last
    slot)."""
    b, plen = prompt.shape
    caches = init_caches(cfg, rt, b, skv, device=device)
    step = make_serve_step(cfg, rt, device)
    tok = prompt[:, :1]
    out = []
    for i in range(plen + steps - 1):
        nxt, caches = step(params, tok, caches)
        if i + 1 < plen:
            tok = prompt[:, i + 1:i + 2]  # teacher-forced prompt phase
        else:
            tok = nxt
            out.append(nxt)
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32, device=prompt.device)
    return torch.cat(out, dim=1)
