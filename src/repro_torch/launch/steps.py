"""Step builders and input specs for the dry run and the launchers (the
counterpart of ``repro.launch.steps``).

The specs are ``meta`` tensors beside ``Axes`` trees: nothing is allocated
for a full-size config. The step functions are the real ones: on the card
(or on CPU tensors where the caller passes ``device="cpu"``) they run the
model; under ``distributed.sharding_ctx`` on DTensors they run the model
tensor-parallel; on fake DTensors the dry run traces them.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.api import Axes
from repro_torch.models import (
    RuntimeConfig,
    cache_axes,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    param_axes,
    prefill_step,
)
from repro_torch.optim import (AdamWConfig, apply_updates, init_opt_state,
                               opt_state_axes, tree_leaves)

META = torch.device("meta")


# --------------------------------------------------------------- specs ----


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """(``meta`` batch tensors, Axes batch) for one input shape."""
    b = shape.global_batch
    if shape.is_decode:
        specs = {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                       device=META)}
        axes = {"tokens": Axes("batch", None)}
        return specs, axes
    s = shape.seq_len
    if cfg.input_mode == "embeddings":
        specs = {"embeds": torch.empty((b, s, cfg.d_model),
                                       dtype=torch.bfloat16, device=META)}
        axes = {"embeds": Axes("batch", None, None)}
    else:
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                       device=META)}
        axes = {"tokens": Axes("batch", None)}
    if shape.kind == "train":
        specs["targets"] = torch.empty((b, s), dtype=torch.int32,
                                       device=META)
        axes["targets"] = Axes("batch", None)
    return specs, axes


def abstract_params(cfg: ModelConfig, rt: RuntimeConfig) -> tuple[Any, Any]:
    """(``meta`` parameters, Axes tree) without allocating."""
    return init_params(cfg, rt, device=META), param_axes(cfg, rt)


def abstract_opt_state(param_shapes, params_axes, opt_cfg: AdamWConfig):
    return (init_opt_state(param_shapes, opt_cfg),
            opt_state_axes(params_axes, opt_cfg))


def abstract_caches(cfg: ModelConfig, rt: RuntimeConfig, batch: int,
                    skv: int):
    return init_caches(cfg, rt, batch, skv, device=META), cache_axes(cfg, rt)


# --------------------------------------------------------------- steps ----


def _microbatch(x, i: int, a: int):
    """Microbatch ``i`` of ``a`` of a batch leaf: rows [i B/a, (i+1) B/a)
    (the JAX package's reshape(a, B/a)); a DTensor sharded on its batch
    takes the i-th piece of each rank's block, so no row moves (the same
    gradient mean, other microbatch members)."""
    if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                      for p in x.placements):
        local = x.to_local()
        n = local.shape[0] // a
        shape = (x.shape[0] // a, *x.shape[1:])
        return DTensor.from_local(local[i * n:(i + 1) * n], x.device_mesh,
                                  x.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=local[:n].stride())
    n = x.shape[0] // a
    return x[i * n:(i + 1) * n]


def _value_and_grad(params, cfg, rt, batch, device):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, cfg, rt, batch, device=device)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def make_train_step_fn(cfg: ModelConfig, rt: RuntimeConfig,
                       opt_cfg: AdamWConfig, device="cuda"):
    """step(params, opt_state, batch) -> (params, opt_state, loss): the
    loss and its gradients (with ``rt.grad_accum`` = a > 1, summed over a
    microbatches of B / a in the parameters' dtype, then divided by a),
    then one ``apply_updates``, in place."""
    a = rt.grad_accum

    def step(params, opt_state, batch):
        if a <= 1:
            loss, grads = _value_and_grad(params, cfg, rt, batch, device)
        else:
            # microbatched gradient accumulation: divides every per-token
            # transient (attention probs, residual cotangents) by `a`
            gsum, lsum = None, 0.0
            for i in range(a):
                mb = {k: _microbatch(v, i, a) for k, v in batch.items()}
                l, g = _value_and_grad(params, cfg, rt, mb, device)
                gsum = ([x.to(p.dtype) for p, x in
                         zip(tree_leaves(params), g)] if gsum is None else
                        [s + x.to(s.dtype) for s, x in zip(gsum, g)])
                lsum = lsum + l
            grads = [g / a for g in gsum]
            loss = lsum / a
        params, opt_state, _ = apply_updates(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, loss
    return step


def make_prefill_fn(cfg: ModelConfig, rt: RuntimeConfig, device="cuda"):
    def step(params, batch):
        return prefill_step(params, cfg, rt, batch, device=device)
    return step


def make_decode_fn(cfg: ModelConfig, rt: RuntimeConfig, device="cuda"):
    """step(params, caches, batch) -> (the argmax token (B, 1) int32, the
    new caches)."""
    def step(params, caches, batch):
        logits, caches = decode_step(params, cfg, rt, batch["tokens"],
                                     caches, device=device)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, caches
    return step
