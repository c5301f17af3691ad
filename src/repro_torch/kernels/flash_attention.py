"""Flash attention: the wrappers of ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward) and their plain PyTorch
versions, side by side.

The counterpart of ``repro.kernels.flash_attention``:

* ``flash_attention`` -- ``flash_attention_pallas`` (no logsumexp);
* ``flash_fwd`` -- ``_flash_fwd``, the forward that also returns the
  logsumexp rows, which ``flash_mha`` (the model's entry) reaches;
* ``flash_bwd_dkv`` / ``flash_bwd_dq`` -- ``_flash_dkv_kernel`` /
  ``_flash_dq_kernel``, and ``flash_bwd`` -- ``_flash_bwd``, which runs
  both after computing delta = rowsum(dO o);
* ``flash_mha`` -- ``flash_mha``, differentiable: a
  ``torch.autograd.Function`` whose forward is ``flash_fwd`` and whose
  backward is ``flash_bwd``.

The kernel wrappers themselves record no gradient and refuse inputs that
require one where autograd is on (``engine.refuse_grad``), as every kernel
of the port; ``flash_mha`` is the differentiable entry.

Layout: q (B*Hq, S, d), k / v (B*Hkv, Skv, d), q heads kv-head-major so
q head ``bh`` reads kv head ``bh // group``. Scores and the accumulator
are fp32; p is rounded to the value type before the p.v product; the
output has q's type, the logsumexp is fp32 (B*Hq, S). The backward takes
dO (and gives dQ) like q, dK / dV like k / v, lse and delta (B*Hq, S)
fp32; it rounds p to dO's type before p^T.dO and dS to the inputs' type
before dS^T.q and dS.k, with fp32 accumulators, as the TPU kernels.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(built by ``engine.build``, counted in ``engine.LAUNCHES``) or raises.
``bq`` / ``bk`` are validated as the JAX package validates them
(``min(bq, S)`` must divide S and ``min(bk, Skv)`` Skv), on both entry
points and both devices: the JAX ``_flash_fwd`` omits that check and
leaves the tail rows unwritten (ROADMAP queue 3), and so does its
``_flash_bwd``, whose grid is ``s // bq`` too: the backward validates them
the same way. The kernels run their own tiles (the bf16 forward 128 q rows
x 128 keys, the others 64 x 64), the plain versions ``bk``-wide kv tiles;
masking, not the tile, decides what a row sees.
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
                             "boundary (the kernel loads float4 / by TMA)")
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
    engine.refuse_grad(name, q, k, v)
    _validate(name, q, k, v, bq, bk, group)
    if engine._device_kind(name, q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, bq, bk, group)
    return _flash_cuda(name, q, k, v, causal, group, lse=True)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 512,
                    bk: int = 512, group: int = 1):
    """Attention forward: q (B*Hq, S, d), k / v (B*Hkv, Skv, d), float32 or
    bfloat16. Returns o (B*Hq, S, d) in q's type."""
    name = "flash_attention"
    engine.refuse_grad(name, q, k, v)
    _validate(name, q, k, v, bq, bk, group)
    if engine._device_kind(name, q) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk,
                                     group=group)
    return _flash_cuda(name, q, k, v, causal, group, lse=False)


def _validate_bwd(name: str, q, k, v, do, lse, delta, bq: int, bk: int,
                  group: int):
    """``_validate`` plus the backward's own inputs: dO like q, lse and
    delta (BH, S) float32."""
    tiles = _validate(name, q, k, v, bq, bk, group)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must be {tuple(q.shape)} {q.dtype} "
                         f"like q, got {tuple(do.shape)} {do.dtype}")
    for key, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be {tuple(q.shape[:2])} "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    return tiles


def _bwd_tiles(q, k, v, do, lse, delta, causal: bool, bk: int, group: int):
    """The backward's tile arithmetic, in plain PyTorch: for each
    ``bk``-wide kv tile (k0, p, dS) over a kv head's ``group`` q heads as one
    block of group * S rows, p = exp(scale q.k^T - lse) (0 where masked) and
    dS = p (dO.v^T - delta) scale, fp32."""
    bh, s, d = q.shape
    bhkv, skv = k.shape[:2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(bhkv, group * s, d)
    dof = do.float().reshape(bhkv, group * s, d)
    lse = lse.reshape(bhkv, group * s, 1)
    delta = delta.reshape(bhkv, group * s, 1)
    qpos = torch.arange(s, device=q.device).repeat(group)
    for k0 in range(0, skv, bk):
        if causal and k0 > s - 1:
            break  # every row's keys end before this tile
        sc = torch.matmul(qf, k[:, k0:k0 + bk].float().transpose(1, 2))
        sc = sc * scale
        if causal:
            kpos = torch.arange(k0, k0 + bk, device=q.device)
            sc = torch.where(qpos[:, None] >= kpos[None, :], sc, NEG_INF)
        p = torch.exp(sc - lse)
        dp = torch.matmul(dof, v[:, k0:k0 + bk].float().transpose(1, 2))
        yield k0, p, p * (dp - delta) * scale


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        bq: int = 512, bk: int = 512, group: int = 1):
    """The dK / dV kernel's function in plain PyTorch: dV = sum of
    round(p)^T dO, dK = sum of round(dS)^T q over a kv head's group, per
    ``bk``-wide kv tile. Returns (dk, dv) in k's type."""
    bq, bk = _validate_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, bq, bk,
                           group)
    bhkv, skv, d = k.shape
    qf = q.float().reshape(bhkv, -1, d)
    dof = do.float().reshape(bhkv, -1, d)
    dk = torch.zeros((bhkv, skv, d), device=q.device)
    dv = torch.zeros((bhkv, skv, d), device=q.device)
    for k0, p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal, bk, group):
        dv[:, k0:k0 + bk] = torch.matmul(
            p.to(do.dtype).float().transpose(1, 2), dof)
        dk[:, k0:k0 + bk] = torch.matmul(
            ds.to(q.dtype).float().transpose(1, 2), qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       bq: int = 512, bk: int = 512, group: int = 1):
    """The dQ kernel's function in plain PyTorch: dQ = sum of round(dS) k
    over ``bk``-wide kv tiles. Returns dq in q's type."""
    bq, bk = _validate_bwd("flash_bwd_dq", q, k, v, do, lse, delta, bq, bk,
                           group)
    bh, s, d = q.shape
    bhkv = k.shape[0]
    dq = torch.zeros((bhkv, group * s, d), device=q.device)
    for k0, _, ds in _bwd_tiles(q, k, v, do, lse, delta, causal, bk, group):
        dq += torch.matmul(ds.to(k.dtype).float(), k[:, k0:k0 + bk].float())
    return dq.reshape(bh, s, d).to(q.dtype)


def _bwd_cuda(name: str, q, k, v, do, lse, delta, causal: bool, group: int):
    """Check CUDA tensors, allocate the outputs and launch kernel
    ``name``."""
    f32 = torch.float32
    engine._check(name, q.device, q=(q, q.dtype), k=(k, q.dtype),
                  v=(v, q.dtype), do=(do, q.dtype), lse=(lse, f32),
                  delta=(delta, f32))
    for key, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary (the kernel loads float4 / 8 x bf16)")
    lib = engine._library(name)
    bh, s, d = q.shape
    outs = ((torch.empty_like(q),) if name == "flash_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    with torch.cuda.device(q.device):
        engine._launch(name, lib, *map(engine._ptr, (q, k, v, do, lse, delta,
                                                     *outs)),
                       bh, s, k.shape[1], d, group, int(bool(causal)),
                       DTYPE_CODES[q.dtype], engine._stream_ptr())
    return outs


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  bq: int = 512, bk: int = 512, group: int = 1):
    """The backward's dK / dV pass: q / dO (B*Hq, S, d), k / v (B*Hkv, Skv,
    d), lse / delta (B*Hq, S) float32. Returns (dk, dv) in k's type."""
    name = "flash_bwd_dkv"
    engine.refuse_grad(name, q, k, v, do, lse, delta)
    _validate_bwd(name, q, k, v, do, lse, delta, bq, bk, group)
    if engine._device_kind(name, q) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, bq, bk,
                                   group)
    return _bwd_cuda(name, q, k, v, do, lse, delta, causal, group)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 bq: int = 512, bk: int = 512, group: int = 1):
    """The backward's dQ pass, on flash_bwd_dkv's inputs. Returns dq in q's
    type."""
    name = "flash_bwd_dq"
    engine.refuse_grad(name, q, k, v, do, lse, delta)
    _validate_bwd(name, q, k, v, do, lse, delta, bq, bk, group)
    if engine._device_kind(name, q) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, bq, bk,
                                  group)
    return _bwd_cuda(name, q, k, v, do, lse, delta, causal, group)[0]


def flash_bwd(q, k, v, o, lse, do, causal: bool = True, bq: int = 512,
              bk: int = 512, group: int = 1):
    """The attention backward from the forward's (q, k, v, o, lse) and the
    output cotangent dO: delta = rowsum(dO o) in fp32 (plain torch ops, as
    the JAX package computes it outside its kernels), then the dK / dV and
    dQ kernels. Returns (dq, dk, dv)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, bq, bk, group)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, bq, bk, group)
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """flash_fwd forward, flash_bwd backward (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk, group):
        o, lse = flash_fwd(q, k, v, causal, bq, bk, group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, bq, bk, group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the model's head transposes hand the cotangent over strided
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_mha(q, k, v, causal: bool = True, bq: int = 512, bk: int = 512,
              group: int = 1):
    """Differentiable flash attention (the model's entry): o of
    ``flash_fwd``; its backward runs ``flash_bwd``. Shapes as
    ``flash_fwd``."""
    return _FlashMHA.apply(q, k, v, causal, bq, bk, group)


class _FlashShapes(torch.autograd.Function):
    """``flash_mha``'s shapes without its work: o and the gradients are
    uninitialised tensors of the right shapes."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.kv_shape = k.shape
        return q.new_empty(q.shape)

    @staticmethod
    def backward(ctx, do):
        return (do.new_empty(do.shape), do.new_empty(ctx.kv_shape),
                do.new_empty(ctx.kv_shape))


def flash_mha_shapes(q, k, v, causal: bool = True, bq: int = 512,
                     bk: int = 512, group: int = 1):
    """A shape-only stand-in of ``flash_mha`` for tracing (the dry run
    costs the kernel by ``flops_bytes``): it checks the shapes as the
    kernel does and computes nothing."""
    _validate("flash_mha", q, k, v, bq, bk, group)
    return _FlashShapes.apply(q, k, v)


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

