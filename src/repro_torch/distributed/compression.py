"""Gradient compression: int8 all-reduce with error feedback, bf16 cast
(the counterpart of ``repro.distributed.compression``).

Each rank runs these on its own tensors (SPMD over a process group):

  JAX (inside shard_map)          port (torch.distributed, ``group``)
  ``jax.lax.pmax(x, axis)``       ``all_reduce(x, MAX, group)``
  ``jax.lax.psum(x, axis)``       ``all_reduce(x, SUM, group)``
  ``jax.lax.pmean(x, axis)``      ``all_reduce(x, SUM, group) / world``
  ``jax.lax.psum(1, axis)``       ``get_world_size(group)``
  ``compressed_psum``             ``compressed_all_reduce``
  ``bf16_psum``                   ``bf16_all_reduce``

``compressed_all_reduce`` quantizes to int8 with a per-block (256) absmax
scale shared across ranks, sums the codes in int32, dequantizes and
divides by the world size; the rank's quantization error is the residual
it adds to the next step's value (error feedback), so the estimate is
unbiased over steps. Wire bytes: ~1/4 of fp32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.api import tree_leaves, tree_unflatten

_BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened to fp32, zero-padded to whole blocks, (nb, 256)."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    npad = (n + _BLOCK - 1) // _BLOCK * _BLOCK
    return torch.nn.functional.pad(flat, (0, npad - n)).reshape(-1, _BLOCK)


def _absmax_scale(padded: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(padded.abs().amax(dim=1) / 127.0, 1e-12)


def _quant_with_scale(x: torch.Tensor, scale: torch.Tensor):
    """Quantize with a GIVEN per-block scale; returns (codes, residual)."""
    padded = _blocks(x)
    q = torch.clamp(torch.round(padded / scale[:, None]), -127, 127).to(
        torch.int8)
    n = x.numel()
    err = (padded - q.float() * scale[:, None]).reshape(-1)[:n].reshape(
        x.shape)
    return q, err


def _quant(x: torch.Tensor):
    """(codes int8 (nb, 256), per-block scale, residual) of ``x``."""
    scale = _absmax_scale(_blocks(x))
    q, err = _quant_with_scale(x, scale)
    return q, scale, err


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compressed_all_reduce(x: torch.Tensor, residual: torch.Tensor,
                          group=None):
    """int8-compressed mean over ``group`` with error feedback. Returns
    (mean-reduced value, new residual).

    Protocol: (1) all-reduce MAX of the per-block absmax scales (tiny),
    (2) every rank quantizes against the SHARED scale, (3) all-reduce SUM
    of the int8 codes in int32, (4) dequantize and divide by the world."""
    y = x + residual
    scale = _absmax_scale(_blocks(y))
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q, err = _quant_with_scale(y, scale)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    cnt = dist.get_world_size(group)
    return _dequant(qsum, scale, y.shape) / cnt, err


def bf16_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Half-precision gradient mean (2x wire bytes saved)."""
    h = x.to(torch.bfloat16)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    return h.float() / dist.get_world_size(group)


def _mean_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    s = x.clone()
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s / dist.get_world_size(group)


def make_compressed_grad_fn(loss_fn, group=None, scheme: str = "int8"):
    """A data-parallel gradient function with compressed reduction.

    ``loss_fn(params, batch) -> scalar`` (mean over the batch it is given).
    Returns ``grad_fn(params, residuals, batch) -> (grads, new_residuals,
    loss)``, run by every rank of ``group`` on the same replicated
    ``params``: each rank takes its slice of the leading axis of every
    batch leaf, differentiates by autograd, and the gradients are reduced
    by ``scheme``: "int8" (``compressed_all_reduce``, residuals updated),
    "bf16" (``bf16_all_reduce``) or anything else, the plain mean. The loss
    is the mean over ranks."""
    def grad_fn(params, residuals, batch):
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        local = tree_unflatten(batch, iter(_rank_slice(b, world, rank)
                                           for b in tree_leaves(batch)))
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, iter(leaves)), local)
            grads = torch.autograd.grad(loss, leaves)
        loss = _mean_all_reduce(loss.detach(), group)
        if scheme == "int8":
            outs = [compressed_all_reduce(g, r, group)
                    for g, r in zip(grads, tree_leaves(residuals))]
            new_g = [o[0] for o in outs]
            new_res = tree_unflatten(residuals, iter(o[1] for o in outs))
        elif scheme == "bf16":
            new_g = [bf16_all_reduce(g, group) for g in grads]
            new_res = residuals
        else:
            new_g = [_mean_all_reduce(g, group) for g in grads]
            new_res = residuals
        return tree_unflatten(params, iter(new_g)), new_res, loss

    return grad_fn


def _rank_slice(b: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s equal slice of ``b``'s leading axis."""
    if b.shape[0] % world:
        raise ValueError(f"batch leaf of leading size {b.shape[0]} does "
                         f"not split over {world} ranks")
    step = b.shape[0] // world
    return b[rank * step:(rank + 1) * step]


def init_residuals(params):
    return tree_unflatten(params, iter(
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)))
