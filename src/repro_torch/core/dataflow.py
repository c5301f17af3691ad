"""Plan executors of the port: level v3, families gcrn and evolve.

``run_plan`` runs one (T, ...) stream and ``run_plan_batched`` B
independent (B, T, ...) streams, ragged over T through the plan's
``lengths``, each in one launch of the family's stream-engine kernel. The
per-step levels of the paper's ablation ladder (baseline, o1, v1, v2) and
the other families are not ported yet and raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core.evolvegcn import EvolveGCN
from repro_torch.core.gcrn import GCRN
from repro_torch.graph.padding import stack_streams

Model = Any  # EvolveGCN | GCRN

_NOT_PORTED_TYPES = {
    "stacked": "ROADMAP.md queue 1 item 7",
    "event_memory": "ROADMAP.md queue 1 item 9",
    "static": "ROADMAP.md queue 1 item 10",
}


def build_model(cfg: DGNNConfig, n_global: int = 4096) -> Model:
    if cfg.dgnn_type == "weights_evolved":
        return EvolveGCN(cfg)
    if cfg.dgnn_type == "integrated":
        return GCRN(cfg, n_global=n_global)
    if cfg.dgnn_type in _NOT_PORTED_TYPES:
        raise NotImplementedError(
            f"dgnn_type {cfg.dgnn_type!r} is not ported to repro_torch yet: "
            f"{_NOT_PORTED_TYPES[cfg.dgnn_type]}")
    raise ValueError(cfg.dgnn_type)


SERVE_ITEM = "the serve layer is ROADMAP.md queue 1 item 12"


def _check_executable(plan) -> None:
    """Raise for plan fields the port cannot execute yet."""
    for f in dataclasses.fields(plan):
        value = getattr(plan, f.name)
        if f.metadata.get("serve") and value != f.default:
            raise NotImplementedError(f"{f.name}={value!r}: {SERVE_ITEM}")
    if plan.level != "v3":
        raise NotImplementedError(
            f"level={plan.level!r}: the port runs the stream engine (v3) "
            "only; the per-step levels are ROADMAP.md queue 1 item 3")
    if plan.state_residency != "vmem":
        raise NotImplementedError(
            "state_residency='hbm_paged' is ROADMAP.md queue 1 item 11")
    if plan.device.n_devices > 1:
        raise NotImplementedError(
            "DeviceSpec sharding is ROADMAP.md queue 1 item 13")


def run_plan(model: Model, params, state0, snaps_T, plan, *,
             force_ref: bool = False):
    """Execute a StreamPlan on one (T, ...) stream of torch tensors.
    Returns (final_state, outputs (T, n_pad, out_dim))."""
    if plan.lengths is not None:
        raise ValueError("plan carries ragged lengths — a batched-launch "
                         "capability; use run_plan_batched")
    _check_executable(plan)
    return model.step_stream(params, state0, snaps_T, tn=plan.tn, td=plan.td,
                             force_ref=force_ref)


def run_plan_batched(model: Model, params, states0, snaps_BT, plan,
                     lengths=None, *, force_ref: bool = False):
    """Execute a StreamPlan on B independent streams: snapshot leaves
    (B, T, ...), state leaves (B, ...), params shared."""
    leaves = states0["weights"] if "weights" in states0 else [states0["h"]]
    B = leaves[0].shape[0]
    if B != plan.batch:
        raise ValueError(f"plan.batch={plan.batch} but the state batch "
                         f"is {B}")
    _check_executable(plan)
    lengths = plan.lengths if lengths is None else lengths
    lens = None if lengths is None else [int(t) for t in lengths]
    return model.step_stream_batched(params, states0, snaps_BT, tn=plan.tn,
                                     td=plan.td, lengths=lens,
                                     force_ref=force_ref)


def init_states_batched(model: Model, params, n_streams: int,
                        mode: str = "v3"):
    """``n_streams`` fresh recurrent states stacked on a leading B axis."""
    s0 = model.init_state(params, mode=mode)
    return {k: ([w[None].expand(n_streams, *w.shape).clone() for w in v]
                if isinstance(v, list)
                else v[None].expand(n_streams, *v.shape).clone())
            for k, v in s0.items()}


def stack_time(padded_snaps: list):
    """Stack per-step PaddedSnapshots (same bucket) along a leading T axis."""
    return stack_streams(padded_snaps)

