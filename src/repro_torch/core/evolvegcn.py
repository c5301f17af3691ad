"""EvolveGCN-O — the weights-evolved DGNN (the paper's V1 base model).

Per GCN layer l, a matrix-GRU evolves the layer weight:
    W_l^t = GRU(W_l^{t-1})            (temporal encoding)
    H^t   = GCN(W^t, G^t)             (spatial encoding)

Dataflow levels:
  baseline   strict chain inside one step: evolve, then the GCN.
  o1         + fused-gate GRU.
  v1         + module overlap (DGNN-Booster V1): the state carries already
             evolved weights W^t, so GCN(W^t, G^t) and GRU(W^t) -> W^{t+1}
             are independent inside a step. Outputs equal baseline's (the
             state is primed by one evolution in ``init_state``).
  v3         time fusion: a whole snapshot stream goes through one launch of
             the EvolveGCN stream-engine kernel (csrc/evolve_engine.cu),
             which keeps W_l on the chip and evolves it between snapshots,
             with v1's primed carry: the kernel consumes the incoming
             weights at its first snapshot and evolves at the end of every
             live step.

An empty snapshot (n_nodes 0) is a no-op at every level: the weights do
not evolve.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.core import gcn as G
from repro_torch.core import rnn as R
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import engine as _engine
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as _ref


def layer_dims(cfg: DGNNConfig) -> list[tuple[int, int]]:
    dims = []
    din = cfg.in_dim
    for l in range(cfg.n_gnn_layers):
        dout = cfg.out_dim if l == cfg.n_gnn_layers - 1 else cfg.hidden
        dims.append((din, dout))
        din = dout
    return dims


class EvolveGCN:
    stream_family = "evolve"

    def __init__(self, cfg: DGNNConfig, impl: str = "xla"):
        assert cfg.dgnn_type == "weights_evolved"
        self.cfg = cfg
        self.impl = impl

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, on the CPU."""
        layers, grus = [], []
        for din, dout in layer_dims(self.cfg):
            layers.append(G.init_gcn_layer(gen, din, dout,
                                           self.cfg.edge_dim))
            grus.append(R.init_gru(gen, din, din))
        return {"gcn": layers, "gru": grus}

    def init_state(self, params: dict, mode: str = "baseline") -> dict:
        """The evolving weights. v1 and v3 prime them by one evolution;
        they then evolve at the end of every live step, so priming here
        and nowhere else keeps one evolution per step."""
        weights = [p["w"] for p in params["gcn"]]
        if mode in ("v1", "v3"):
            weights = [R.matrix_gru(g, w, fused=True)
                       for g, w in zip(params["gru"], weights)]
        return {"weights": weights}

    def step(self, params: dict, state: dict, snap: PaddedSnapshot, *,
             mode: str = "baseline", force_ref: bool = False):
        """One snapshot at a per-step level (baseline / o1 / v1). Returns
        (new state, outputs (n_pad, out_dim))."""
        live = snap.n_nodes > 0
        if mode in ("v1", "v3"):
            # the GCN and the GRU are independent given the primed carry
            w_now = state["weights"]
            out = G.gcn_forward_weights(params["gcn"], w_now, snap,
                                        snap.node_feat, impl=self.impl,
                                        force_ref=force_ref)
            w_next = [torch.where(live, R.matrix_gru(g, w, fused=True), w)
                      for g, w in zip(params["gru"], w_now)]
            return {"weights": w_next}, out
        # baseline / o1: evolve, then apply: the sequential critical path
        w_now = [torch.where(live, R.matrix_gru(g, w, fused=mode == "o1"), w)
                 for g, w in zip(params["gru"], state["weights"])]
        out = G.gcn_forward_weights(params["gcn"], w_now, snap,
                                    snap.node_feat, impl=self.impl,
                                    force_ref=force_ref)
        return {"weights": w_now}, out

    def _edge_aggs(self, params: dict, snaps: PaddedSnapshot, *,
                   force_ref: bool = False):
        """Per-layer pre-aggregated edge term sum_k coef[v,k] *
        (edge_feat @ w_edge_l)[eidx[v,k]]. It is additive in the ELL
        aggregation, so it factors out of the engine. Its sums run in a
        fixed order, lane by lane, so a snapshot's term has the same bits
        whatever the launch's B and T: the serve engine's chunking, tick by
        tick under the continuous scheduler, must not change what a tenant
        is served.

        The terms come as one (..., L, n, dmax) tensor, the square layout
        the evolve engine reads (``engine.edge_terms``). CUDA tensors take
        the edge-term kernel; the CPU and ``force_ref`` its plain version,
        the torch ops of ``ref.evolve_edge_terms`` (the same bits)."""
        if not self.cfg.edge_dim:
            return None
        terms = _engine.edge_terms_plain if force_ref else _engine.edge_terms
        with obs.span("edge_terms"):
            return terms(snaps.neigh_eidx.to(torch.int32).contiguous(),
                         snaps.neigh_coef.contiguous(),
                         snaps.edge_feat.contiguous(),
                         snaps.n_nodes.to(torch.int32).contiguous(),
                         [p["w_edge"] for p in params["gcn"]],
                         kops.square_width(layer_dims(self.cfg)))

    def stream_args(self, params: dict, state: dict, snaps: PaddedSnapshot,
                    *, force_ref: bool = False) -> tuple:
        """The stream engine's argument list for ``snaps`` (the order of
        kernels/ops.stream_steps), live flags and edge terms built here."""
        # no-op (all-padding) snapshots must not evolve the weights
        live = (snaps.n_nodes > 0).to(torch.int32)
        return (snaps.neigh_idx, snaps.neigh_coef, snaps.node_feat,
                snaps.node_mask, live, list(state["weights"]),
                [p["b"] for p in params["gcn"]],
                [g["wx"] for g in params["gru"]],
                [g["wh"] for g in params["gru"]],
                [g["b"] for g in params["gru"]],
                self._edge_aggs(params, snaps, force_ref=force_ref))

    def _run(self, params: dict, state: dict, snaps: PaddedSnapshot,
             batched: bool, tn=128, td="cfg", lengths=None,
             state_residency="vmem", buffer_depth=None, force_ref=False,
             device_spec=None):
        td = self.cfg.stream_td if td == "cfg" else td
        dev = params["gru"][0]["wx"].device
        args = self.stream_args(params, state, snaps, force_ref=force_ref)
        if batched:
            outs, wT = kops.stream_steps_batched(
                self.stream_family, *args, tn=tn, td=td, lengths=lengths,
                state_residency=state_residency, buffer_depth=buffer_depth,
                force_ref=force_ref, device=dev, device_spec=device_spec)
        else:
            outs, wT = kops.stream_steps(
                self.stream_family, *args, tn=tn, td=td,
                state_residency=state_residency, buffer_depth=buffer_depth,
                force_ref=force_ref, device=dev)
        return {"weights": list(wT)}, outs

    def step_stream(self, params: dict, state: dict, snaps_T: PaddedSnapshot,
                    *, tn=128, td="cfg", state_residency="vmem",
                    buffer_depth=None, force_ref=False):
        """V3: a whole (T, ...) stream through the weights-resident kernel
        (or its paged variant: ``state_residency="hbm_paged"``)."""
        return self._run(params, state, snaps_T, batched=False, tn=tn, td=td,
                         state_residency=state_residency,
                         buffer_depth=buffer_depth, force_ref=force_ref)

    def step_stream_batched(self, params: dict, state: dict,
                            snaps_BT: PaddedSnapshot, *, tn=128, td="cfg",
                            lengths=None, state_residency="vmem",
                            buffer_depth=None, force_ref=False,
                            device_spec=None):
        """Batched V3: B independent streams, weight state leaves
        (B, din_l, dout_l), one launch; ``lengths`` runs it ragged."""
        return self._run(params, state, snaps_BT, batched=True, tn=tn, td=td,
                         lengths=lengths, state_residency=state_residency,
                         buffer_depth=buffer_depth, force_ref=force_ref,
                         device_spec=device_spec)
