"""GQA attention: grouped einsum, q-chunked long-sequence path, the flash
kernel, KV-cache decode (the counterpart of ``repro.nn.attention``).

Never materializes the KV-head repeat: queries reshape to
(B, S, Hkv, group, hd) and scores are computed per KV head group.

Paths:
  full      plain softmax attention (S small);
  chunked   a loop over query chunks, each attending the full (masked) KV;
  flash     the hand-written flash kernel (kernels/flash_attention.py);
  decode    one-token query against a cache laid out (B, Skv, Hkv, hd).

The JAX package's ``shard`` annotations and its ``shard_map`` around the
flash kernel are not ported yet (the LM under a mesh: ROADMAP queue 1);
attention runs replicated on every rank. A decode cache's ``len`` is a host-side
int32 tensor: the position is read every step to place the new key and to
refuse a write past the end, without a device sync.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.kernels.ops import resolve_device
from repro_torch.nn.layers import ACT_DTYPE, apply_rope, normal_init, rms_norm

NEG_INF = -1e30


def init_attention(generator, cfg: ModelConfig, tp: int, *, device="cuda",
                   dtype=torch.float32):
    device = resolve_device(device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq = cfg.padded_heads(tp)
    hkv = cfg.padded_kv_heads(tp)
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    init = lambda shape, scale: normal_init(generator, shape, scale,
                                            device=device, dtype=dtype)
    p = {
        "wq": init((d, hq, hd), 0.02),
        "wk": init((d, hkv, hd), 0.02),
        "wv": init((d, hkv, hd), 0.02),
        "wo": init((hq, hd, d), o_scale),
    }
    zeros = lambda *shape: torch.zeros(shape, device=device, dtype=dtype)
    if cfg.qkv_bias:
        p["bq"] = zeros(hq, hd)
        p["bk"] = zeros(hkv, hd)
        p["bv"] = zeros(hkv, hd)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device, dtype=dtype)
        p["k_norm"] = torch.ones((hd,), device=device, dtype=dtype)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """x: (B, S, D) -> q (B,S,Hq,hd), k,v (B,S,Hkv,hd); RoPE + qk_norm."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ACT_DTYPE))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(ACT_DTYPE))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(ACT_DTYPE))
    if cfg.qkv_bias:
        q = q + p["bq"].to(ACT_DTYPE)
        k = k + p["bk"].to(ACT_DTYPE)
        v = v + p["bv"].to(ACT_DTYPE)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k (B,Sk,Hkv,hd) -> (B,Hkv,G,Sq,Sk) fp32 logits."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float()
    return s / math.sqrt(hd)


def _grouped_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,Hkv,G,Sq,Sk), v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd)."""
    b, hkv, g, sq, sk = probs.shape
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(v.dtype), v)
    return out.reshape(b, sq, hkv * g, v.shape[-1])


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    scores = _grouped_scores(q, k)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 2048):
    """A loop over query chunks; each chunk attends the full masked KV.
    Under autograd each chunk is recomputed in the backward (the JAX
    package's ``jax.checkpoint``), so only one chunk's probabilities live
    at a time."""
    b, s, hq, hd = q.shape
    if s <= chunk:
        return full_attention(q, k, v, causal=causal)
    if s % chunk:
        raise ValueError(f"chunked_attention: S={s} is not a multiple of "
                         f"chunk={chunk}")

    def one(qi, i):
        return full_attention(qi, k, v, causal=causal, q_offset=i)

    if torch.is_grad_enabled():
        outs = [checkpoint(one, q[:, i:i + chunk], i, use_reentrant=False)
                for i in range(0, s, chunk)]
    else:
        outs = [one(q[:, i:i + chunk], i) for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """q (B,1,Hq,hd) vs cache (B,Skv,Hkv,hd); positions >= kv_len masked.
    ``kv_len`` is a scalar, so the mask is one (1, Skv) row for the whole
    batch, as in the JAX package."""
    scores = _grouped_scores(q, k_cache)                 # (B,Hkv,G,1,Skv)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    if isinstance(kv_len, int):  # the host-side length: no device copy
        mask = (kpos < kv_len)[None, :]
    else:
        mask = kpos[None, :] < kv_len.to(q.device)[..., None]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v_cache)


def flash_attention(q, k, v, *, causal: bool, bq: int = 512, bk: int = 512):
    """The flash kernel on q (B,S,Hq,hd), k/v (B,S,Hkv,hd); heads kv-major
    like the grouped-einsum path."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q2 = q.transpose(1, 2).reshape(b * hq, s, hd)
    k2 = k.transpose(1, 2).reshape(b * hkv, k.shape[1], hd)
    v2 = v.transpose(1, 2).reshape(b * hkv, v.shape[1], hd)
    o = flash_mha(q2, k2, v2, causal, bq, bk, g)
    return o.reshape(b, hq, s, hd).transpose(1, 2)


def _cache_pos(cache: dict, new: int) -> int:
    """The cache's write position; refuses a write past its end (where the
    JAX package's dynamic_update_slice would clamp and overwrite the last
    slot)."""
    pos = int(cache["len"])
    skv = cache["k"].shape[1]
    if pos + new > skv:
        raise ValueError(f"KV cache full: {new} new token(s) at position "
                         f"{pos} of a cache of {skv} (pass a larger skv)")
    return pos


def _update(cache_t: torch.Tensor, new: torch.Tensor, pos: int):
    """A copy of ``cache_t`` (B,Skv,...) with ``new`` (B,S,...) written at
    sequence position ``pos`` (dynamic_update_slice_in_dim, axis 1)."""
    out = cache_t.clone()
    out[:, pos:pos + new.shape[1]] = new.to(cache_t.dtype)
    return out


def attention_block(p: dict, cfg: ModelConfig, x: torch.Tensor, positions,
                    *, attn_chunk: int = 2048, cache: Optional[dict] = None,
                    long_ctx: bool = False, attn_impl: str = "xla",
                    flash_bq: int = 512, flash_bk: int = 512):
    """Full attention sublayer (no norm/residual). Returns (out, new_cache).

    cache (decode): {"k": (B,Skv,Hkv,hd) bf16, "v": same, "len": () int32
    on the host}; with ``kv_quant``, int8 "k"/"v" and bf16 "k_s"/"v_s"
    (B,Skv,Hkv) scales. The caches are not written in place: the new cache
    is a copy, as in the JAX package.
    """
    q, k, v = _project_qkv(p, cfg, x, positions)
    if cache is not None:
        pos = _cache_pos(cache, k.shape[1])
        new_len = torch.tensor(pos + 1, dtype=torch.int32)
        if "k_s" in cache:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            k_cache = _update(cache["k"], kq, pos)
            v_cache = _update(cache["v"], vq, pos)
            ks_c = _update(cache["k_s"], ks, pos)
            vs_c = _update(cache["v_s"], vs, pos)
            out = decode_attention(q, _kv_dequantize(k_cache, ks_c),
                                   _kv_dequantize(v_cache, vs_c), pos + 1)
            new_cache = {"k": k_cache, "v": v_cache, "k_s": ks_c,
                         "v_s": vs_c, "len": new_len}
        else:
            if long_ctx:
                k_cache = _write_kv(cache["k"], k, pos)
                v_cache = _write_kv(cache["v"], v, pos)
            else:
                k_cache = _update(cache["k"], k, pos)
                v_cache = _update(cache["v"], v, pos)
            out = decode_attention(q, k_cache, v_cache, pos + 1)
            new_cache = {"k": k_cache, "v": v_cache, "len": new_len}
    else:
        if attn_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal, bq=flash_bq,
                                  bk=flash_bk)
        elif x.shape[1] > attn_chunk:
            out = chunked_attention(q, k, v, causal=cfg.causal,
                                    chunk=attn_chunk)
        else:
            out = full_attention(q, k, v, causal=cfg.causal)
        new_cache = None
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ACT_DTYPE))
    return y, new_cache


def _write_kv(cache: torch.Tensor, new: torch.Tensor, pos: int):
    """cache (B,Skv,Hkv,hd); new (B,1,Hkv,hd); the one-hot blend of the
    sequence-sharded (long_ctx) write, at seq position pos."""
    onehot = (torch.arange(cache.shape[1], device=cache.device) == pos).to(
        cache.dtype)
    return (cache * (1 - onehot)[None, :, None, None]
            + new.to(cache.dtype) * onehot[None, :, None, None])


def init_decode_cache(cfg: ModelConfig, batch: int, skv: int, tp: int,
                      dtype=torch.bfloat16, quant: bool = False,
                      device="cuda"):
    device = resolve_device(device)
    hkv, hd = cfg.padded_kv_heads(tp), cfg.resolved_head_dim
    length = torch.zeros((), dtype=torch.int32)  # host-side position
    if quant:
        # int8 KV cache with per-(token, head) absmax scales
        return {
            "k": torch.zeros((batch, skv, hkv, hd), dtype=torch.int8,
                             device=device),
            "v": torch.zeros((batch, skv, hkv, hd), dtype=torch.int8,
                             device=device),
            "k_s": torch.zeros((batch, skv, hkv), dtype=torch.bfloat16,
                               device=device),
            "v_s": torch.zeros((batch, skv, hkv), dtype=torch.bfloat16,
                               device=device),
            "len": length,
        }
    return {
        "k": torch.zeros((batch, skv, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, skv, hkv, hd), dtype=dtype, device=device),
        "len": length,
    }


def _kv_quantize(x: torch.Tensor):
    """x (B,1,Hkv,hd) -> (int8 codes, bf16 scale (B,1,Hkv))."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def _kv_dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.bfloat16) * s.to(torch.bfloat16)[..., None]
