"""GQA attention: grouped einsum, q-chunked long-sequence path, the flash
kernel, KV-cache decode (the counterpart of ``repro.nn.attention``).

Never materializes the KV-head repeat: queries reshape to
(B, S, Hkv, group, hd) and scores are computed per KV head group.

Paths:
  full      plain softmax attention (S small);
  chunked   a loop over query chunks, each attending the full (masked) KV;
  flash     the hand-written flash kernel (kernels/flash_attention.py);
  decode    one-token query against a cache laid out (B, Skv, Hkv, hd).

Under a mesh (``distributed.sharding_ctx``) q / k / v and the output are
sharded by heads over 'model' and by batch over ('pod', 'data') through
the JAX package's ``shard`` calls (DTensors: column-parallel projections,
a row-parallel ``wo``), and a decode cache by ``kv_seq`` (``kv_seq_dp``
under ``long_ctx``). The attention itself (flash, full, chunked, decode)
runs on each rank's local (batch, heads) block through ``local_map``
(``on_head_blocks``; the JAX package's ``shard_map`` around flash): a dim
that does not divide its mesh axes goes unsplit, as there, and a kv-head
count that does not divide the heads' split raises (the kernel never
runs on a gathered copy). A ``long_ctx`` decode reduces over its split
cache on the DTensors. A decode cache's ``len`` is a host-side
int32 tensor: the position is read every step to place the new key and to
refuse a write past the end, without a device sync.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import (Axes, gather_fsdp,
                                         local_tensor,
                                         mesh_axis_sizes, placements,
                                         replicated, shard)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ops import resolve_device
from repro_torch.nn.layers import ACT_DTYPE, apply_rope, normal_init, rms_norm

NEG_INF = -1e30

#: the flash path's entry: the kernel, or in ``flash_shapes_only`` its
#: shape-only stand-in
_FLASH = {"mha": FA.flash_mha}


@contextmanager
def flash_shapes_only():
    """Within, the flash path runs ``flash_mha_shapes`` (nothing computed):
    the dry run traces the model so and costs the kernel in closed form
    (``roofline.corrections.flash_correction``)."""
    old = _FLASH["mha"]
    _FLASH["mha"] = FA.flash_mha_shapes
    try:
        yield
    finally:
        _FLASH["mha"] = old


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


def attention_axes(cfg: ModelConfig) -> dict:
    ax = {
        "wq": Axes("embed_fsdp", "heads", None),
        "wk": Axes("embed_fsdp", "kv_heads", None),
        "wv": Axes("embed_fsdp", "kv_heads", None),
        "wo": Axes("heads", None, "embed_fsdp"),
    }
    if cfg.qkv_bias:
        ax["bq"] = Axes("heads", None)
        ax["bk"] = Axes("kv_heads", None)
        ax["bv"] = Axes("kv_heads", None)
    if cfg.qk_norm:
        ax["q_norm"] = Axes(None)
        ax["k_norm"] = Axes(None)
    return ax


def _w(p: dict, name: str, heads: str):
    """A q / k / v projection (D, H, hd) in bf16, its FSDP dim gathered."""
    return gather_fsdp(p[name].to(ACT_DTYPE), "embed_fsdp", heads, None)


def _project(x, w):
    """x (B,S,D) @ w (D,H,hd) -> (B,S,H,hd). On DTensors each rank
    multiplies its blocks (``local_map``): its batch of x, whole over
    'model', and its heads of w (its FSDP dim gathered); x's gradient sums
    over the heads' split, w's over the batch's. (DTensor's own einsum
    views lose a split of one local head in the backward.)"""
    proj = lambda x_, w_: torch.einsum("bsd,dhk->bshk", x_, w_)
    if not isinstance(w, DTensor):
        return proj(x, w)
    x = replicated(x, w)
    x_pl, w_pl = list(x.placements), list(w.placements)
    if not all((xp, wp) in ((Replicate(), Replicate()), (Replicate(), Shard(1)),
                            (Shard(0), Replicate()))
               for xp, wp in zip(x_pl, w_pl)):
        raise ValueError(f"projection under a mesh: x {x_pl} (batch split, "
                         f"else whole) and w {w_pl} (heads split, else "
                         f"whole) expected")
    out = [Shard(2) if wp == Shard(1) else xp for xp, wp in zip(x_pl, w_pl)]
    gx = [Partial() if wp == Shard(1) else xp for xp, wp in zip(x_pl, w_pl)]
    gw = [Partial() if xp == Shard(0) else wp for xp, wp in zip(x_pl, w_pl)]
    return local_map(proj, out_placements=out, in_placements=(x_pl, w_pl),
                     in_grad_placements=(gx, gw), device_mesh=w.device_mesh)(
        x, w)


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """x: (B, S, D) -> q (B,S,Hq,hd), k,v (B,S,Hkv,hd); RoPE + qk_norm."""
    q = _project(x, _w(p, "wq", "heads"))
    k = _project(x, _w(p, "wk", "kv_heads"))
    v = _project(x, _w(p, "wv", "kv_heads"))
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
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
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
        mask = replicated(qpos[:, None] >= kpos[None, :], scores)
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
        mask = replicated((kpos < kv_len)[None, :], scores)
    else:
        mask = replicated(kpos, scores)[None, :] < kv_len.to(q.device)[..., None]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v_cache)


def _flash_local(q, k, v, causal: bool, bq: int, bk: int):
    """The flash kernel on one block: q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q2 = q.transpose(1, 2).reshape(b * hq, s, hd)
    k2 = k.transpose(1, 2).reshape(b * hkv, k.shape[1], hd)
    v2 = v.transpose(1, 2).reshape(b * hkv, v.shape[1], hd)
    o = _FLASH["mha"](q2, k2, v2, causal, bq, bk, g)
    return o.reshape(b, hq, s, hd).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool, bq: int = 512, bk: int = 512):
    """The flash kernel on q (B,S,Hq,hd), k/v (B,S,Hkv,hd); heads kv-major
    like the grouped-einsum path. On DTensors each rank runs it on its
    local (batch, heads) block (``on_head_blocks``)."""
    return on_head_blocks(
        lambda q_, k_, v_: _flash_local(q_, k_, v_, causal, bq, bk), q, k, v)


def on_head_blocks(fn, q, k, v):
    """``fn(q, k, v)`` -> (B, S, Hq, hd), the attention of independent
    (batch, head) pairs. On DTensors, each rank's local block through
    ``local_map``: batch over ('pod', 'data') and heads over 'model' where
    they divide (else that dim unsplit, the JAX package's fallback); a
    kv-head count that does not divide the heads' split raises (never a
    gathered copy). Plain tensors: ``fn`` itself."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    sizes = mesh_axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    bspec = (batch_axes if batch_axes
             and q.shape[0] % _axes_size(mesh, batch_axes) == 0 else None)
    hspec = ("model" if "model" in sizes
             and q.shape[2] % _axes_size(mesh, ("model",)) == 0 else None)
    if hspec and k.shape[2] % sizes["model"]:
        raise ValueError(
            f"attention under a mesh: {q.shape[2]} q heads split over "
            f"'model' ({sizes['model']}) but {k.shape[2]} kv heads do not; "
            f"pad the kv heads (cfg.padded_kv_heads) or shrink the model "
            f"axis")
    pl = list(placements((bspec, None, hspec, None), mesh))
    return local_map(fn, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, *(replicated(t, q) for t in (k, v)))


def _axes_size(mesh, axes) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _cache_pos(cache: dict, new: int) -> int:
    """The cache's write position; refuses a write past its end (where the
    JAX package's dynamic_update_slice would clamp and overwrite the last
    slot)."""
    pos = int(local_tensor(cache["len"]))
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
        kv_ax = "kv_seq_dp" if long_ctx else "kv_seq"
        new_len = torch.tensor(pos + 1, dtype=torch.int32)
        if "k_s" in cache:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            k_cache = _update(cache["k"], kq, pos)
            v_cache = _update(cache["v"], vq, pos)
            ks_c = _update(cache["k_s"], ks, pos)
            vs_c = _update(cache["v_s"], vs, pos)
            k_full = shard(_kv_dequantize(k_cache, ks_c), "batch", kv_ax,
                           "kv_heads", None)
            v_full = shard(_kv_dequantize(v_cache, vs_c), "batch", kv_ax,
                           "kv_heads", None)
            out = _decode_blocks(q, k_full, v_full, pos + 1, long_ctx)
            new_cache = {"k": k_cache, "v": v_cache, "k_s": ks_c,
                         "v_s": vs_c, "len": new_len}
        else:
            if long_ctx:
                k_cache = _write_kv(cache["k"], k, pos)
                v_cache = _write_kv(cache["v"], v, pos)
            else:
                k_cache = _update(cache["k"], k, pos)
                v_cache = _update(cache["v"], v, pos)
            k_cache = shard(k_cache, "batch", kv_ax, "kv_heads", None)
            v_cache = shard(v_cache, "batch", kv_ax, "kv_heads", None)
            out = _decode_blocks(q, k_cache, v_cache, pos + 1, long_ctx)
            new_cache = {"k": k_cache, "v": v_cache, "len": new_len}
    else:
        if attn_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal, bq=flash_bq,
                                  bk=flash_bk)
        elif x.shape[1] > attn_chunk:
            out = on_head_blocks(lambda q_, k_, v_: chunked_attention(
                q_, k_, v_, causal=cfg.causal, chunk=attn_chunk), q, k, v)
        else:
            out = on_head_blocks(lambda q_, k_, v_: full_attention(
                q_, k_, v_, causal=cfg.causal), q, k, v)
        new_cache = None
    out = shard(out, "batch", None, "heads", None)
    y = torch.einsum("bshk,hkd->bsd", out, gather_fsdp(
        p["wo"].to(ACT_DTYPE), "heads", None, "embed_fsdp"))
    return y, new_cache


def _decode_blocks(q, k_cache, v_cache, kv_len, long_ctx: bool):
    """``decode_attention`` on each rank's (batch, heads) block; with
    ``long_ctx`` (the cache's sequence split over 'data') on the DTensors
    themselves, whose softmax reduces over the split."""
    if long_ctx:
        return decode_attention(q, k_cache, v_cache, kv_len)
    return on_head_blocks(lambda q_, k_, v_: decode_attention(
        q_, k_, v_, kv_len), q, k_cache, v_cache)


def _write_kv(cache: torch.Tensor, new: torch.Tensor, pos: int):
    """cache (B,Skv,Hkv,hd); new (B,1,Hkv,hd); the one-hot blend of the
    sequence-sharded (long_ctx) write, at seq position pos."""
    onehot = replicated((torch.arange(cache.shape[1], device=cache.device)
                         == pos).to(cache.dtype), cache)
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
