"""Plan executors of the port: every dataflow level of the paper's ladder
for the three dense-snapshot families (gcrn, evolve, stacked), and levels
baseline and v3 of the event-driven tgn and the static static_gcn.

  baseline   strict GNN/RNN chain per time step, staged RNN gates.
  o1         Pipeline-O1: fused RNN gate pipeline.
  v1         module overlap of GNN and RNN in adjacent steps: EvolveGCN
             through its primed carry (core/evolvegcn.py), the stacked
             family as a software pipeline with a one-step register
             (``_run_stacked_v1``).
  v2         intra-step fusion: one fused kernel per step (GCRN, stacked).
  v3         time fusion: the whole (T, ...) stream in one launch of the
             family's stream-engine kernel, ragged over T through the
             plan's ``lengths``.

The per-step levels run a Python loop over T (the JAX package's
``lax.scan``) and, batched, a loop over B (its ``vmap``), equal T only.
Every level computes the same function. For tgn, T counts event batches
(graph/events.PaddedEventBlock); static_gcn has no state and folds its
snapshots onto the batch axis at v3.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core.evolvegcn import EvolveGCN
from repro_torch.core.gcn import StaticGCN
from repro_torch.core.gcrn import GCRN
from repro_torch.core.stacked import StackedDGNN
from repro_torch.core.tgn import TGNModel
from repro_torch.graph.padding import stack_streams
from repro_torch.kernels import ops as kops

Model = Any  # EvolveGCN | GCRN | StackedDGNN | StaticGCN | TGNModel


def build_model(cfg: DGNNConfig, impl: str = "xla",
                n_global: int = 4096) -> Model:
    """The config's model; ``impl`` picks the message-passing path of the
    per-step levels ("xla": edge-parallel PyTorch, "pallas": the ELL SpMM
    kernel)."""
    if cfg.dgnn_type == "weights_evolved":
        return EvolveGCN(cfg, impl=impl)
    if cfg.dgnn_type == "integrated":
        return GCRN(cfg, impl=impl, n_global=n_global)
    if cfg.dgnn_type == "stacked":
        return StackedDGNN(cfg, impl=impl, n_global=n_global)
    if cfg.dgnn_type == "static":
        return StaticGCN(cfg, impl=impl, n_global=n_global)
    if cfg.dgnn_type == "event_memory":
        return TGNModel(cfg, impl=impl, n_global=n_global)
    raise ValueError(cfg.dgnn_type)


SERVE_ITEM = "the serve layer is ROADMAP.md queue 1 item 12"


def _check_executable(plan) -> None:
    """Raise for plan fields the port cannot execute yet."""
    for f in dataclasses.fields(plan):
        value = getattr(plan, f.name)
        if f.metadata.get("serve") and value != f.default:
            raise NotImplementedError(f"{f.name}={value!r}: {SERVE_ITEM}")
    if plan.state_residency != "vmem":
        raise NotImplementedError(
            "state_residency='hbm_paged' is ROADMAP.md queue 1 item 11")
    if plan.device.n_devices > 1:
        raise NotImplementedError(
            "DeviceSpec sharding is ROADMAP.md queue 1 item 13")


def _at(snaps, i: int):
    """Entry ``i`` of the leading axis of every leaf of a padded snapshot
    or event block."""
    return type(snaps)(**{f.name: getattr(snaps, f.name)[i]
                          for f in dataclasses.fields(snaps)})


def _leaves(tree) -> list:
    """Tensors of a state dict (sorted keys, lists in order) or of a padded
    snapshot / event block (field order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return [tree]


def _scan_steps(model: Model, params, state0, snaps_T, mode: str,
                force_ref: bool):
    state, outs = state0, []
    for t in range(snaps_T.node_mask.shape[0]):
        state, out = model.step(params, state, _at(snaps_T, t), mode=mode,
                                force_ref=force_ref)
        outs.append(out)
    return state, torch.stack(outs)


def _run_stacked_v1(model: StackedDGNN, params, state0, snaps_T,
                    force_ref: bool):
    """Software-pipelined stacked DGNN: GCN(G^t) beside GRU(X^{t-1}).

    Pipeline register: (X^{t-1}, snap^{t-1}). The prologue computes X^0;
    step t >= 1 computes X^t (GNN) and consumes X^{t-1} (RNN), two
    independent pieces of work; the epilogue drains the last X. The outputs
    equal the sequential schedule's."""
    prev = _at(snaps_T, 0)
    x_prev = model.gnn(params, prev, force_ref=force_ref)  # prologue
    state, outs = state0, []
    for t in range(1, snaps_T.node_mask.shape[0]):
        snap = _at(snaps_T, t)
        x_t = model.gnn(params, snap, force_ref=force_ref)
        state, h = model.rnn(params, state, prev, x_prev, fused=True)
        outs.append(h)
        x_prev, prev = x_t, snap
    state, h = model.rnn(params, state, prev, x_prev, fused=True)  # epilogue
    outs.append(h)
    return state, torch.stack(outs)


def run_plan(model: Model, params, state0, snaps_T, plan, *,
             force_ref: bool = False):
    """Execute a StreamPlan on one (T, ...) stream of torch tensors.
    Returns (final_state, outputs (T, n_pad, out_dim))."""
    if plan.lengths is not None:
        raise ValueError("plan carries ragged lengths — a batched-launch "
                         "capability; use run_plan_batched")
    _check_executable(plan)
    if plan.level == "v3":
        return model.step_stream(params, state0, snaps_T, tn=plan.tn,
                                 td=plan.td, force_ref=force_ref)
    n_global = getattr(model, "n_global", None)
    if n_global is not None:  # a store: its rows are checked once a stream
        kops.check_renumber(snaps_T.renumber, n_global)
    if plan.level == "v1" and isinstance(model, StackedDGNN):
        return _run_stacked_v1(model, params, state0, snaps_T, force_ref)
    return _scan_steps(model, params, state0, snaps_T, plan.level, force_ref)


def _state_at(states, b: int) -> dict:
    return {k: [w[b] for w in v] if isinstance(v, list) else v[b]
            for k, v in states.items()}


def _stack_states(states: list) -> dict:
    return {k: ([torch.stack([s[k][i] for s in states])
                 for i in range(len(v))] if isinstance(v, list)
                else torch.stack([s[k] for s in states]))
            for k, v in states[0].items()}


def run_plan_batched(model: Model, params, states0, snaps_BT, plan,
                     lengths=None, *, force_ref: bool = False):
    """Execute a StreamPlan on B independent streams: snapshot leaves
    (B, T, ...), state leaves (B, ...), params shared. Level v3 runs the
    batch in one launch, ragged over T through ``lengths``; the per-step
    levels run the streams one after another, equal T only."""
    # a static family's state is empty: the snapshots give the batch size
    B = (_leaves(states0) or _leaves(snaps_BT))[0].shape[0]
    if B != plan.batch:
        raise ValueError(f"plan.batch={plan.batch} but the state batch "
                         f"is {B}")
    _check_executable(plan)
    lengths = plan.lengths if lengths is None else lengths
    if plan.level == "v3":
        lens = None if lengths is None else [int(t) for t in lengths]
        return model.step_stream_batched(params, states0, snaps_BT,
                                         tn=plan.tn, td=plan.td,
                                         lengths=lens, force_ref=force_ref)
    if lengths is not None:
        raise ValueError("ragged lengths need the stream engine "
                         f"(level='v3'); level={plan.level!r}")
    runs = [run_plan(model, params, _state_at(states0, b), _at(snaps_BT, b),
                     plan, force_ref=force_ref) for b in range(B)]
    return (_stack_states([s for s, _ in runs]),
            torch.stack([o for _, o in runs]))


def init_states_batched(model: Model, params, n_streams: int,
                        mode: str = "baseline"):
    """``n_streams`` fresh recurrent states stacked on a leading B axis."""
    s0 = model.init_state(params, mode=mode)
    return {k: ([w[None].expand(n_streams, *w.shape).clone() for w in v]
                if isinstance(v, list)
                else v[None].expand(n_streams, *v.shape).clone())
            for k, v in s0.items()}


def stack_time(padded_snaps: list):
    """Stack per-step padded snapshots or event blocks (same bucket) along
    a leading T axis."""
    return stack_streams(padded_snaps)
