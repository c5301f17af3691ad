"""GCRN-M2 — the integrated DGNN (the paper's V2 base model).

Graph-convolutional LSTM: every gate matmul of the LSTM is a graph
convolution, GNN1 on the input features and GNN2 on the hidden state:

    gates = GC_x(x^t; G^t) + GC_h(h^{t-1}; G^t) + b
    c^t   = sigmoid(f)*c^{t-1} + sigmoid(i)*tanh(g)
    h^t   = sigmoid(o)*tanh(c^t)

Per-node recurrent state lives in a global store (n_global, H); the
renumber table gathers the active rows before a step and scatters the new
rows back. The port runs level v3: a whole snapshot stream goes through
one launch of the GCRN stream-engine kernel (kernels/ops.stream_steps).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import rnn as R
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import ops as kops


class GCRN:
    stream_family = "gcrn"

    def __init__(self, cfg: DGNNConfig, n_global: int = 4096):
        assert cfg.dgnn_type == "integrated"
        self.cfg = cfg
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

    def init_state(self, params: dict, mode: str = "v3") -> dict:
        dev = params["lstm"]["wx"].device
        shape = (self.n_global, self.cfg.hidden)
        return {"h": torch.zeros(shape, device=dev),
                "c": torch.zeros(shape, device=dev)}

    def stream_args(self, params: dict, state: dict,
                    snaps: PaddedSnapshot) -> tuple:
        """The stream engine's argument list for ``snaps`` (the order of
        kernels/ops.stream_steps), edge messages projected here."""
        w_edge = params.get("w_edge")
        edge_msg = snaps.edge_feat @ w_edge if w_edge is not None else None
        return (snaps.neigh_idx, snaps.neigh_coef, snaps.neigh_eidx,
                snaps.node_feat, snaps.renumber, snaps.node_mask,
                state["h"], state["c"],
                params["lstm"]["wx"], params["lstm"]["wh"],
                params["lstm"]["b"], edge_msg)

    def _stream(self, params: dict, state: dict, snaps: PaddedSnapshot,
                batched: bool, tn=128, td="cfg", lengths=None,
                force_ref=False):
        td = self.cfg.stream_td if td == "cfg" else td
        dev = params["lstm"]["wx"].device
        args = self.stream_args(params, state, snaps)
        if batched:
            outs_h, h_T, c_T = kops.stream_steps_batched(
                self.stream_family, *args, tn=tn, td=td, lengths=lengths,
                force_ref=force_ref, device=dev)
        else:
            outs_h, h_T, c_T = kops.stream_steps(
                self.stream_family, *args, tn=tn, td=td, force_ref=force_ref,
                device=dev)
        out = outs_h @ params["head"]["w"] + params["head"]["b"]
        mask = snaps.node_mask
        if lengths is not None:
            # ragged T: the launch masks the dead tail; mirror it on the
            # output mask so the head bias reads as zero there
            live = (torch.arange(mask.shape[1], device=dev)[None, :]
                    < torch.as_tensor(lengths, device=dev)[:, None])
            mask = mask * live[:, :, None]
        return {"h": h_T, "c": c_T}, out * mask[..., None]

    def step_stream(self, params: dict, state: dict, snaps_T: PaddedSnapshot,
                    *, tn=128, td="cfg", force_ref=False):
        """V3: a whole (T, ...) snapshot stream through the stream engine."""
        return self._stream(params, state, snaps_T, batched=False, tn=tn,
                            td=td, force_ref=force_ref)

    def step_stream_batched(self, params: dict, state: dict,
                            snaps_BT: PaddedSnapshot, *, tn=128, td="cfg",
                            lengths=None, force_ref=False):
        """Batched V3: B independent (B, T, ...) streams, state leaves
        (B, n_global, H), one launch; ``lengths`` runs it ragged over T."""
        return self._stream(params, state, snaps_BT, batched=True, tn=tn,
                            td=td, lengths=lengths, force_ref=force_ref)
