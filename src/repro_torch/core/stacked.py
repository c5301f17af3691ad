"""Stacked DGNN (GCRN-M1 / WD-GCN style): a GCN feeds a per-node GRU.

The third discrete-time DGNN type of the paper's Table I; both V1 and V2
apply to it:

    X^t = GCN(G^t)                 (independent across time)
    h^t = GRU(X^t, h^{t-1})        (chained across time, per node)

Per-node state lives in a global store (n_global, H), gathered and
scattered through the renumber table as in core/gcrn.py.

Dataflow levels:
  baseline   GCN then GRU, chained inside every step.
  o1         + fused-gate GRU.
  v1         software-pipelined: the GCN of step t and the GRU of step t-1
             are independent (core/dataflow.py carries X^{t-1} in a
             one-step register, with a prologue and an epilogue).
  v2         intra-step fusion: the last GCN layer and the GRU of a node
             tile run in one kernel (kernels/ops.stacked_fused_step,
             csrc/stacked_step.cu).
  v3         time fusion (``step_stream``): the last GCN layer and the GRU
             of the whole stream run in one launch of the stacked
             stream-engine kernel (csrc/stacked_engine.cu) over the h
             store. The GCN layers before the last are time-independent
             and run before it, over every snapshot at once.

Edge features enter at layer 0. With one GCN layer that is the fused
layer, and the kernels take the projected edge messages; with more, layer
0 runs outside the kernels and they take none.
"""
from __future__ import annotations

import torch

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import gcn as G
from repro_torch.core import rnn as R
from repro_torch.core.gcrn import gather_rows, scatter_rows
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import ops as kops


class StackedDGNN:
    stream_family = "stacked"

    def __init__(self, cfg: DGNNConfig, impl: str = "xla",
                 n_global: int = 4096):
        assert cfg.dgnn_type == "stacked"
        self.cfg = cfg
        self.impl = impl
        self.n_global = n_global

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, on the CPU."""
        cfg = self.cfg
        layers, din = [], cfg.in_dim
        for l in range(cfg.n_gnn_layers):
            layers.append(G.init_gcn_layer(gen, din, cfg.hidden,
                                           cfg.edge_dim if l == 0 else 0))
            din = cfg.hidden
        return {"gcn": layers, "gru": R.init_gru(gen, cfg.hidden, cfg.hidden)}

    def init_state(self, params: dict, mode: str = "baseline") -> dict:
        """The global h store. v1's pipeline register lives in
        core/dataflow.py, not in the state."""
        dev = params["gru"]["wx"].device
        return {"h": torch.zeros((self.n_global, self.cfg.hidden),
                                 device=dev)}

    def gnn(self, params: dict, snap: PaddedSnapshot, *,
            force_ref: bool = False) -> torch.Tensor:
        return G.gcn_forward(params["gcn"], snap, snap.node_feat,
                             impl=self.impl, force_ref=force_ref)

    def rnn(self, params: dict, state: dict, snap: PaddedSnapshot,
            x: torch.Tensor, *, fused: bool):
        h = gather_rows(state["h"], snap)
        h_new = R.gru_cell(params["gru"], x, h, fused=fused)
        h_new = h_new * snap.node_mask[:, None]
        return {"h": scatter_rows(state["h"], snap, h_new)}, h_new

    def _fused_inputs(self, params: dict, snaps: PaddedSnapshot,
                      force_ref: bool):
        """The input of the last GCN layer (the earlier layers applied,
        over any leading axes) and its edge messages, which exist only
        when the last layer is layer 0."""
        x = snaps.node_feat
        for p in params["gcn"][:-1]:
            x = G.gcn_layer(p, snaps, x, impl=self.impl, force_ref=force_ref)
        w_edge = params["gcn"][0].get("w_edge")
        edge_msg = (snaps.edge_feat @ w_edge
                    if w_edge is not None and len(params["gcn"]) == 1
                    else None)
        return x, edge_msg

    def step(self, params: dict, state: dict, snap: PaddedSnapshot, *,
             mode: str = "baseline", force_ref: bool = False):
        """One snapshot at a per-step level (baseline / o1 / v2). Returns
        (new state, h' (n_pad, H))."""
        if mode == "v2":
            x, edge_msg = self._fused_inputs(params, snap, force_ref)
            p_last, gru = params["gcn"][-1], params["gru"]
            h = gather_rows(state["h"], snap)
            h_new = kops.stacked_fused_step(
                snap.neigh_idx, snap.neigh_coef, snap.neigh_eidx, x, h,
                p_last["w"], p_last["b"], gru["wx"], gru["wh"], gru["b"],
                edge_msg, force_ref=force_ref)
            h_new = h_new * snap.node_mask[:, None]
            return {"h": scatter_rows(state["h"], snap, h_new)}, h_new
        x = self.gnn(params, snap, force_ref=force_ref)
        return self.rnn(params, state, snap, x, fused=mode in ("o1", "v1"))

    def stream_args(self, params: dict, state: dict, snaps: PaddedSnapshot,
                    *, force_ref: bool = False) -> tuple:
        """The stream engine's argument list for ``snaps`` (the order of
        kernels/ops.stream_steps): the earlier GCN layers applied here."""
        x, edge_msg = self._fused_inputs(params, snaps, force_ref)
        p_last, gru = params["gcn"][-1], params["gru"]
        return (snaps.neigh_idx, snaps.neigh_coef, snaps.neigh_eidx, x,
                snaps.renumber, snaps.node_mask, state["h"], p_last["w"],
                p_last["b"], gru["wx"], gru["wh"], gru["b"], edge_msg)

    def _stream(self, params: dict, state: dict, snaps: PaddedSnapshot,
                batched: bool, tn=128, td="cfg", lengths=None,
                state_residency="vmem", buffer_depth=None, force_ref=False,
                device_spec=None):
        td = self.cfg.stream_td if td == "cfg" else td
        dev = params["gru"]["wx"].device
        args = self.stream_args(params, state, snaps, force_ref=force_ref)
        if batched:
            outs_h, h_T = kops.stream_steps_batched(
                self.stream_family, *args, tn=tn, td=td, lengths=lengths,
                state_residency=state_residency, buffer_depth=buffer_depth,
                force_ref=force_ref, device=dev, device_spec=device_spec)
        else:
            outs_h, h_T = kops.stream_steps(
                self.stream_family, *args, tn=tn, td=td,
                state_residency=state_residency, buffer_depth=buffer_depth,
                force_ref=force_ref, device=dev)
        return {"h": h_T}, outs_h

    def step_stream(self, params: dict, state: dict, snaps_T: PaddedSnapshot,
                    *, tn=128, td="cfg", state_residency="vmem",
                    buffer_depth=None, force_ref=False):
        """V3: a whole (T, ...) snapshot stream through the stream engine."""
        return self._stream(params, state, snaps_T, batched=False, tn=tn,
                            td=td, state_residency=state_residency,
                            buffer_depth=buffer_depth, force_ref=force_ref)

    def step_stream_batched(self, params: dict, state: dict,
                            snaps_BT: PaddedSnapshot, *, tn=128, td="cfg",
                            lengths=None, state_residency="vmem",
                            buffer_depth=None, force_ref=False,
                            device_spec=None):
        """Batched V3: B independent (B, T, ...) streams, state leaves
        (B, n_global, H), one launch; ``lengths`` runs it ragged over T."""
        return self._stream(params, state, snaps_BT, batched=True, tn=tn,
                            td=td, lengths=lengths,
                            state_residency=state_residency,
                            buffer_depth=buffer_depth, force_ref=force_ref,
                            device_spec=device_spec)
