"""Fault-tolerant training loop (the counterpart of ``repro.train.loop``).

- resume from the latest checkpoint on start;
- periodic async checkpoints, and a blocking save on the way out (a
  SIGTERM sets a stop flag; the loop ends after its current step);
- per-step time, taken after a device sync so that it is the card's and
  not the launch queue's, with a straggler deadline: steps over it are
  counted and reported;
- parameters and optimizer state updated in place (where the JAX package
  donates them).

The loop runs on the parameters' device, the card unless the caller asks
for the CPU.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim import (AdamWConfig, apply_updates, init_opt_state,
                               tree_leaves)


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10
    straggler_deadline_s: float = 60.0


@dataclass
class TrainResult:
    final_step: int
    losses: list
    step_times: list
    straggler_steps: int
    resumed_from: Optional[int]


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """loss_fn(params, batch) -> scalar. Returns step(params, opt_state,
    batch) -> (params, opt_state, metrics): the loss, its gradients by
    autograd, then ``apply_updates``, in place."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(loss_fn: Callable, params, batches: Iterable,
          opt_cfg: AdamWConfig, loop_cfg: TrainLoopConfig, *,
          device="cuda") -> tuple[Any, TrainResult]:
    """Run the loop; returns (final params, TrainResult). ``params`` must
    be on ``device``."""
    dev = resolve_device(device)
    for p in tree_leaves(params):
        if p.device.type != dev.type:
            raise ValueError(f"a parameter is on {p.device}, the loop on "
                             f"{dev}")
    mgr = None
    resumed_from = None
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0
    if loop_cfg.checkpoint_dir:
        mgr = CheckpointManager(loop_cfg.checkpoint_dir, loop_cfg.keep_last)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            resumed_from = latest

    step_fn = make_train_step(loss_fn, opt_cfg)

    stop = {"flag": False}

    def handler(signum, frame):
        stop["flag"] = True

    old_term = signal.signal(signal.SIGTERM, handler)

    losses, times = [], []
    stragglers = 0
    step = start_step
    try:
        it = iter(batches)
        while step < loop_cfg.total_steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            _sync(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(dev)
            dt = time.perf_counter() - t0
            step += 1
            losses.append(float(metrics["loss"]))
            times.append(dt)
            if dt > loop_cfg.straggler_deadline_s:
                stragglers += 1
            if mgr and step % loop_cfg.checkpoint_every == 0:
                mgr.save(step, {"params": params, "opt": opt_state})
            if stop["flag"]:
                break
    finally:
        if mgr:
            mgr.save(step, {"params": params, "opt": opt_state},
                     blocking=True)
        signal.signal(signal.SIGTERM, old_term)

    return params, TrainResult(step, losses, times, stragglers, resumed_from)
