"""Common NN layers: norms, RoPE, embeddings, init helpers.

The counterpart of ``repro.nn.layers``. Init functions return the
parameters alone, on the card unless the caller passes ``device="cpu"``
(or ``"meta"`` for the layout alone); beside each, an ``*_axes`` function
returns the logical-axis tree the JAX package's init returns with them
(``Axes`` leaves, which ``distributed.tree_shardings`` resolves against a
mesh). Tensors the layers build themselves (RoPE's frequencies, the vocab
mask) join the mesh of the DTensor they meet through
``distributed.replicated``. Compute follows
the bf16-activations / fp32-norms-and-softmax convention, with the JAX
package's two switches: ``set_lowmem_norm`` (off by default; on, norms
and RoPE touch the wide tensor only in its own type) and ``bf16_cotangent`` (the
training loss's ``rt.bwd_bf16``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.api import Axes, replicated, shard
from repro_torch.kernels.ops import resolve_device

ACT_DTYPE = torch.bfloat16


def normal_init(generator, shape, scale: float, *, device="cuda",
                dtype=torch.float32) -> torch.Tensor:
    """N(0, scale^2) in fp32 from ``generator``, returned in ``dtype``. On
    the ``meta`` device it only allocates the shape (no draw)."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.empty(shape, device=device, dtype=dtype)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot draw on "
                         f"{device}: pass torch.Generator(device="
                         f"{device.type!r})")
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


#: the low-memory norm switch (per process, off by default): the norms and
#: RoPE touch the wide (B, S, ...) tensor only in its own dtype
LOWMEM_NORM = False


def set_lowmem_norm(v: bool) -> None:
    global LOWMEM_NORM
    LOWMEM_NORM = bool(v)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics, the result cast back to ``x.dtype``; under
    ``LOWMEM_NORM`` the normalisation itself runs in ``x.dtype``."""
    xf32 = x.float()
    var = torch.mean(xf32 * xf32, dim=-1, keepdim=True)
    if LOWMEM_NORM:
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * scale.to(x.dtype)
    return ((xf32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


class _Bf16Cotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # demote to bf16, then to the primal dtype if that is narrower
        g = g.to(torch.bfloat16)
        return g if ctx.dtype == torch.bfloat16 else g.to(ctx.dtype)


def bf16_cotangent(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward rounds the cotangent through bf16: at the
    backbone -> loss boundary it demotes the backward residual-stream chain
    from the fp32 the loss head promotes to, to bf16. Parameter gradients
    keep their dtype."""
    return _Bf16Cotangent.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s formula, x * (1 / (1 + exp(-x))), each op in x's
    dtype: in bf16 it rounds where the JAX package's does (``F.silu``
    rounds once, a bf16 ulp apart on ~40 % of the elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def init_rms_norm(d: int, *, device="cuda", dtype=torch.float32):
    return torch.ones((d,), device=resolve_device(device), dtype=dtype)


def rms_norm_axes() -> Axes:
    return Axes(None)


def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=resolve_device(device)) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves RoPE. x: (..., S, H, hd); positions: broadcastable to
    (..., S). The trig runs in fp32; the rotation in fp32 too, or in
    ``x.dtype`` under ``LOWMEM_NORM``; the result is cast back to
    ``x.dtype``."""
    hd = x.shape[-1]
    freqs = replicated(rope_freqs(hd, theta, x.device),       # (hd/2,)
                       positions)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    wide = x.dtype if LOWMEM_NORM else torch.float32
    cos = torch.cos(ang)[..., None, :].to(wide)              # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :].to(wide)
    x1, x2 = torch.chunk(x.to(wide), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(generator, vocab_pad: int, d: int, *, device="cuda",
                   dtype=torch.float32):
    return normal_init(generator, (vocab_pad, d), 0.02, device=device,
                       dtype=dtype)


def embedding_axes() -> Axes:
    return Axes("vocab", "embed_fsdp")


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """A bf16 gather: the rows are gathered, then cast (the same values as
    casting the table first, without a cast copy of the whole table). A
    vocab-sharded DTensor table is looked up where it lies (each rank its
    rows, the rest masked, then summed), never gathered whole; an FSDP
    table's embed dim is gathered over 'data' first, as every FSDP weight
    is before use."""
    w = shard(w, "vocab", None)
    return torch.nn.functional.embedding(tokens.long(), w).to(ACT_DTYPE)


def init_lm_head(generator, d: int, vocab_pad: int, *, device="cuda",
                 dtype=torch.float32):
    return normal_init(generator, (d, vocab_pad), 0.02, device=device,
                       dtype=dtype)


def lm_head_axes() -> Axes:
    return Axes("embed_fsdp", "vocab")


def vocab_mask(vocab_pad: int, vocab: int, device="cuda") -> torch.Tensor:
    """0 for real vocab entries, -1e9 (not -inf) for padding columns."""
    cols = torch.arange(vocab_pad, device=resolve_device(device))
    return torch.where(cols < vocab, 0.0, -1e9).to(torch.float32)
