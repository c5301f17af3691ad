"""GCRN-M2 — the integrated DGNN (the paper's V2 base model).

Graph-convolutional LSTM: every gate matmul of the LSTM is a graph
convolution, GNN1 on the input features and GNN2 on the hidden state:

    gates = GC_x(x^t; G^t) + GC_h(h^{t-1}; G^t) + b
    c^t   = sigmoid(f)*c^{t-1} + sigmoid(i)*tanh(g)
    h^t   = sigmoid(o)*tanh(c^t)

Per-node recurrent state lives in a global store (n_global, H); the
renumber table gathers the active rows before a step and scatters the new
rows back.

Dataflow levels:
  baseline   staged gates (one convolution matmul per gate and input).
  o1         fused gates (one concatenated matmul per input).
  v2         + intra-step GNN/RNN fusion: aggregation, gate transform and
             the LSTM update of a node tile run in one kernel
             (kernels/ops.dgnn_fused_step, csrc/gcrn_step.cu).
  v3         + time fusion (``step_stream``): a whole snapshot stream goes
             through one launch of the GCRN stream-engine kernel
             (kernels/ops.stream_steps, csrc/gcrn_engine.cu).
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import gcn as G
from repro_torch.core import rnn as R
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import ops as kops


def gather_rows(store: torch.Tensor, snap: PaddedSnapshot) -> torch.Tensor:
    """The step's rows of a (G, H) store, masked (padding reads row 0)."""
    safe = torch.where(snap.renumber >= 0, snap.renumber, 0).long()
    return store[safe] * snap.node_mask[:, None]


def scatter_rows(store: torch.Tensor, snap: PaddedSnapshot,
                 val: torch.Tensor) -> torch.Tensor:
    """A new store with the step's rows replaced by ``val``; padding rows
    (renumber -1) drop. The renumber rows lie inside the store (the
    executors check it once per stream, ``kops.check_renumber``)."""
    G_rows = store.shape[0]
    idx = torch.where(snap.renumber >= 0, snap.renumber, G_rows).long()
    out = torch.cat([store, store.new_zeros(1, store.shape[1])])
    return out.index_copy_(0, idx, val)[:G_rows]


class GCRN:
    stream_family = "gcrn"

    def __init__(self, cfg: DGNNConfig, impl: str = "xla",
                 n_global: int = 4096):
        assert cfg.dgnn_type == "integrated"
        self.cfg = cfg
        self.impl = impl
        self.n_global = n_global

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, on the CPU."""
        cfg = self.cfg
        p = {
            "lstm": R.init_lstm(gen, cfg.in_dim, cfg.hidden),
            "head": {
                "w": torch.randn(cfg.hidden, cfg.out_dim, generator=gen)
                * (1.0 / math.sqrt(cfg.hidden)),
                "b": torch.zeros(cfg.out_dim),
            },
        }
        if cfg.edge_dim:
            escale = 1.0 / math.sqrt(cfg.edge_dim)
            p["w_edge"] = (torch.rand(cfg.edge_dim, cfg.in_dim, generator=gen)
                           * 2 - 1) * escale
        return p

    def init_state(self, params: dict, mode: str = "baseline") -> dict:
        dev = params["lstm"]["wx"].device
        shape = (self.n_global, self.cfg.hidden)
        return {"h": torch.zeros(shape, device=dev),
                "c": torch.zeros(shape, device=dev)}

    def step(self, params: dict, state: dict, snap: PaddedSnapshot, *,
             mode: str = "baseline", force_ref: bool = False):
        """One snapshot at a per-step level (baseline / o1 / v2). Returns
        (new state, masked head outputs (n_pad, out_dim))."""
        h = gather_rows(state["h"], snap)
        c = gather_rows(state["c"], snap)
        x = snap.node_feat
        w_edge = params.get("w_edge")
        if mode == "v2":
            edge_msg = snap.edge_feat @ w_edge if w_edge is not None else None
            h_new, c_new = kops.dgnn_fused_step(
                snap.neigh_idx, snap.neigh_coef, snap.neigh_eidx, x, h, c,
                params["lstm"]["wx"], params["lstm"]["wh"],
                params["lstm"]["b"], edge_msg, force_ref=force_ref)
        else:
            # GNN1 aggregates the input features, GNN2 the hidden state
            if self.impl == "pallas":
                agg_x = G.propagate_ell(snap, x, w_edge, force_ref=force_ref)
                agg_h = G.propagate_ell(snap, h, None, force_ref=force_ref)
            else:
                agg_x = G.propagate_segment(snap, x, w_edge)
                agg_h = G.propagate_segment(snap, h, None)
            gates = R.lstm_gates(params["lstm"], agg_x, agg_h,
                                 fused=mode == "o1")
            h_new, c_new = R.lstm_apply_gates(gates, c)
        m = snap.node_mask[:, None]
        h_new, c_new = h_new * m, c_new * m
        out = h_new @ params["head"]["w"] + params["head"]["b"]
        new_state = {"h": scatter_rows(state["h"], snap, h_new),
                     "c": scatter_rows(state["c"], snap, c_new)}
        return new_state, out * m

    def stream_args(self, params: dict, state: dict,
                    snaps: PaddedSnapshot) -> tuple:
        """The stream engine's argument list for ``snaps`` (the order of
        kernels/ops.stream_steps), edge messages projected here."""
        w_edge = params.get("w_edge")
        edge_msg = None
        if w_edge is not None:
            with obs.span("edge_terms"):
                edge_msg = snaps.edge_feat @ w_edge
        return (snaps.neigh_idx, snaps.neigh_coef, snaps.neigh_eidx,
                snaps.node_feat, snaps.renumber, snaps.node_mask,
                state["h"], state["c"],
                params["lstm"]["wx"], params["lstm"]["wh"],
                params["lstm"]["b"], edge_msg)

    def _stream(self, params: dict, state: dict, snaps: PaddedSnapshot,
                batched: bool, tn=128, td="cfg", lengths=None,
                state_residency="vmem", buffer_depth=None, force_ref=False,
                device_spec=None):
        td = self.cfg.stream_td if td == "cfg" else td
        dev = params["lstm"]["wx"].device
        args = self.stream_args(params, state, snaps)
        if batched:
            outs_h, h_T, c_T = kops.stream_steps_batched(
                self.stream_family, *args, tn=tn, td=td, lengths=lengths,
                state_residency=state_residency, buffer_depth=buffer_depth,
                force_ref=force_ref, device=dev, device_spec=device_spec)
        else:
            outs_h, h_T, c_T = kops.stream_steps(
                self.stream_family, *args, tn=tn, td=td,
                state_residency=state_residency, buffer_depth=buffer_depth,
                force_ref=force_ref, device=dev)
        with obs.span("head"):
            out = outs_h @ params["head"]["w"] + params["head"]["b"]
            mask = snaps.node_mask
            if lengths is not None:
                # ragged T: the launch masks the dead tail; mirror it on
                # the output mask so the head bias reads as zero there.
                # The lengths' copy waits for the launch queued ahead.
                with obs.sync(dev, "lengths"):
                    lens = torch.as_tensor(lengths, device=dev)
                live = (torch.arange(mask.shape[1], device=dev)[None, :]
                        < lens[:, None])
                mask = mask * live[:, :, None]
            return {"h": h_T, "c": c_T}, out * mask[..., None]

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
