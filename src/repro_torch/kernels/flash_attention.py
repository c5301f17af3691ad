"""Flash attention forward: the wrappers of ``csrc/flash_attention.cu`` and
their plain PyTorch versions, side by side.

The counterpart of ``repro.kernels.flash_attention``:

* ``flash_attention`` -- ``flash_attention_pallas`` (no logsumexp);
* ``flash_fwd`` -- ``_flash_fwd``, the forward that also returns the
  logsumexp rows, which ``flash_mha`` (the model's entry) reaches;
* ``flash_mha`` -- ``flash_mha``'s primal. Its backward kernels are not
  ported yet (ROADMAP queue 2 #14), so it refuses inputs that need a
  gradient instead of differentiating the plain version.

Layout: q (B*Hq, S, d), k / v (B*Hkv, Skv, d), q heads kv-head-major so
q head ``bh`` reads kv head ``bh // group``. Scores and the accumulator
are fp32; p is rounded to the value type before the p.v product; the
output has q's type, the logsumexp is fp32 (B*Hq, S).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(built by ``engine.build``, counted in ``engine.LAUNCHES``) or raises.
``bq`` / ``bk`` are validated as the JAX package validates them
(``min(bq, S)`` must divide S and ``min(bk, Skv)`` Skv), on both entry
points and both devices: the JAX ``_flash_fwd`` omits that check and
leaves the tail rows unwritten (ROADMAP queue 3). The kernel runs its own
64 x 64 tiles, the plain version ``bk``-wide kv tiles; masking, not the
tile, decides what a row sees.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import engine

NEG_INF = -1e30
#: the largest head_dim the kernel takes (any multiple of 8 up to it)
MAX_HEAD_DIM = 128
#: the kernel's dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(name: str, q, k, v, bq: int, bk: int, group: int):
    """Shapes, types and tiles of one call; returns the effective
    (bq, bk)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: q (BH, S, d), k / v (BH / group, Skv, d) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    skv = k.shape[1]
    if k.shape[2] != d:
        raise ValueError(f"{name}: head_dim {k.shape[2]} of k, {d} of q")
    if not (isinstance(group, int) and group > 0 and bh % group == 0
            and k.shape[0] == bh // group):
        raise ValueError(f"{name}: {bh} q heads, {k.shape[0]} kv heads and "
                         f"group {group!r} do not fit (kv heads = q heads "
                         "/ group)")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share one of "
                         f"{sorted(map(str, DTYPE_CODES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if s == 0 or skv == 0:
        raise ValueError(f"{name}: empty sequence (S={s}, Skv={skv})")
    bq, bk = min(bq, s), min(bk, skv)
    if bq <= 0 or bk <= 0 or s % bq or skv % bk:
        raise ValueError(
            f"{name}: min(bq, S) = {bq} must divide S = {s} and min(bk, Skv)"
            f" = {bk} must divide Skv = {skv}; otherwise the tail rows would "
            "be left unwritten")
    return bq, bk


def flash_fwd_plain(q, k, v, causal: bool = True, bq: int = 512,
                    bk: int = 512, group: int = 1):
    """The kernel's function in plain PyTorch: the online softmax over
    ``bk``-wide kv tiles, with the TPU kernel's numerics. Returns
    (o, lse)."""
    bq, bk = _validate("flash_fwd", q, k, v, bq, bk, group)
    bh, s, d = q.shape
    bhkv, skv = k.shape[:2]
    # a kv head's `group` q heads as one block of group * S rows
    qf = q.float().reshape(bhkv, group * s, d)
    qpos = torch.arange(s, device=q.device).repeat(group)
    m = torch.full((bhkv, group * s), NEG_INF, device=q.device)
    l = torch.zeros((bhkv, group * s), device=q.device)
    acc = torch.zeros((bhkv, group * s, d), device=q.device)
    scale = math.sqrt(d)
    for k0 in range(0, skv, bk):
        if causal and k0 > s - 1:
            break  # every row's keys end before this tile
        sc = torch.matmul(qf, k[:, k0:k0 + bk].float().transpose(1, 2))
        sc = sc / scale
        if causal:
            kpos = torch.arange(k0, k0 + bk, device=q.device)
            sc = torch.where(qpos[:, None] >= kpos[None, :], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v[:, k0:k0 + bk].float())
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    o = (acc / l[..., None]).to(q.dtype).reshape(bh, s, d)
    return o, (m + torch.log(l)).reshape(bh, s)


def flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 512,
                          bk: int = 512, group: int = 1):
    """``flash_attention``'s function in plain PyTorch (the forward
    without the logsumexp)."""
    bq, bk = _validate("flash_attention", q, k, v, bq, bk, group)
    return flash_fwd_plain(q, k, v, causal, bq, bk, group)[0]


def _flash_cuda(name: str, q, k, v, causal: bool, group: int, lse: bool):
    """Check CUDA tensors, allocate the outputs and launch kernel
    ``name``."""
    engine._check(name, q.device, q=(q, q.dtype), k=(k, q.dtype),
                  v=(v, q.dtype))
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary (the kernel loads float4 / 4 x bf16)")
    lib = engine._library(name)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse_t = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
             if lse else None)
    with torch.cuda.device(q.device):
        engine._launch(name, lib, engine._ptr(q), engine._ptr(k),
                       engine._ptr(v), engine._ptr(o), engine._ptr(lse_t),
                       bh, s, k.shape[1], d, group, int(bool(causal)),
                       DTYPE_CODES[q.dtype], engine._stream_ptr())
    return (o, lse_t) if lse else o


def flash_fwd(q, k, v, causal: bool = True, bq: int = 512, bk: int = 512,
              group: int = 1):
    """Attention forward with the logsumexp rows: q (B*Hq, S, d), k / v
    (B*Hkv, Skv, d), float32 or bfloat16. Returns (o (B*Hq, S, d) in q's
    type, lse (B*Hq, S) float32)."""
    name = "flash_fwd"
    _validate(name, q, k, v, bq, bk, group)
    if engine._device_kind(name, q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, bq, bk, group)
    return _flash_cuda(name, q, k, v, causal, group, lse=True)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 512,
                    bk: int = 512, group: int = 1):
    """Attention forward: q (B*Hq, S, d), k / v (B*Hkv, Skv, d), float32 or
    bfloat16. Returns o (B*Hq, S, d) in q's type."""
    name = "flash_attention"
    _validate(name, q, k, v, bq, bk, group)
    if engine._device_kind(name, q) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk,
                                     group=group)
    return _flash_cuda(name, q, k, v, causal, group, lse=False)


def flash_mha(q, k, v, causal: bool = True, bq: int = 512, bk: int = 512,
              group: int = 1):
    """The model's attention entry: ``flash_fwd(...)[0]``, forward only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_mha: no gradient in the port yet (backward kernels: "
            "ROADMAP queue 2 #14)")
    return flash_fwd(q, k, v, causal, bq, bk, group)[0]


def flops_bytes(b: int, hq: int, hkv: int, s: int, d: int, *,
                causal: bool = True, bq: int = 512, bk: int = 512) -> dict:
    """Work and traffic of the TPU kernel's tiling (a copy of the JAX
    package's count): 4 d flops per (q, k) pair of its executed tiles; q / o
    once, K / V tiles once per executed tile pair, all at 2 bytes."""
    nq, nk = s // bq, s // bk
    pairs = 0
    for i in range(nq):
        for j in range(nk):
            if not causal or j * bk <= i * bq + bq - 1:
                pairs += 1
    flops = 4.0 * b * hq * pairs * bq * bk * d
    bytes_kv = 2.0 * b * hkv * nq * 0 + 2.0 * b * hq * pairs * bk * d * 2
    bytes_qo = 2.0 * b * hq * s * d * 2
    return {"flops": flops, "bytes": bytes_kv + bytes_qo, "tile_pairs": pairs}

