"""GCN spatial encoder: message passing (MP), then node transform (NT).

  MP: agg[v] = sum over in-edges (u -> v) of coef(u, v) * (x[u] + edge_feat @ w_edge),
      coef the symmetric GCN normalisation (computed on the host at renumbering);
  NT: h'[v] = act(agg[v] @ W + b).

Two paths compute the same MP:
  impl="xla"    edge-parallel gather and ``index_add_`` over the COO arrays
                (plain PyTorch; the JAX package's XLA path);
  impl="pallas" the ELL SpMM kernel over the ELL arrays (kernels/ops.ell_spmm,
                csrc/ell_spmm.cu), the V2 building block.

Snapshot leaves may carry leading axes ((T,) or (B, T)) shared by ``x``:
every graph is aggregated on its own, in one call. ``force_ref`` sends the
ELL path to its plain oracle instead of the kernel wrapper.

``StaticGCN`` is the "static" temporal contract's model: the plain
multi-layer GCN with no recurrence and no state.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def init_gcn_layer(gen: torch.Generator, din: int, dout: int,
                   edge_dim: int) -> dict:
    """Random GCN layer parameters from ``gen``, on the CPU."""
    scale = 1.0 / math.sqrt(din)
    p = {"w": (torch.rand(din, dout, generator=gen) * 2 - 1) * scale,
         "b": torch.zeros(dout)}
    if edge_dim:
        escale = 1.0 / math.sqrt(edge_dim)
        p["w_edge"] = (torch.rand(edge_dim, din, generator=gen) * 2 - 1) * escale
    return p


def propagate_segment(snap: PaddedSnapshot, x: torch.Tensor,
                      w_edge=None) -> torch.Tensor:
    """MP stage, edge-parallel: gather each edge's source row, add its
    edge message, scale by coef and sum into its destination row."""
    lead, (n, d) = x.shape[:-2], x.shape[-2:]
    src, dst = snap.src.long(), snap.dst.long()
    msgs = torch.gather(x, -2, src[..., None].expand(*src.shape, d))
    if w_edge is not None:
        msgs = msgs + snap.edge_feat @ w_edge
    msgs = msgs * snap.coef[..., None]
    graphs = math.prod(lead)
    offset = (torch.arange(graphs, device=x.device) * n).reshape(*lead, 1)
    out = x.new_zeros(graphs * n, d).index_add_(
        0, (dst + offset).reshape(-1), msgs.reshape(-1, d))
    return out.reshape(*lead, n, d)


def propagate_ell(snap: PaddedSnapshot, x: torch.Tensor, w_edge=None, *,
                  force_ref: bool = False) -> torch.Tensor:
    """MP stage over the ELL layout, through the ELL SpMM kernel."""
    edge_msg = snap.edge_feat @ w_edge if w_edge is not None else None
    return kops.ell_spmm(snap.neigh_idx, snap.neigh_coef, snap.neigh_eidx, x,
                         edge_msg, force_ref=force_ref)


def gcn_layer(params: dict, snap: PaddedSnapshot, x: torch.Tensor, *,
              act=torch.relu, impl: str = "xla",
              force_ref: bool = False) -> torch.Tensor:
    """One GCN layer: MP then NT (the paper's stage order), masked."""
    w_edge = params.get("w_edge")
    if impl == "pallas":
        agg = propagate_ell(snap, x, w_edge, force_ref=force_ref)
    else:
        agg = propagate_segment(snap, x, w_edge)
    h = agg @ params["w"] + params["b"]
    if act is not None:
        h = act(h)
    return h * snap.node_mask[..., None]


def gcn_forward(layers: list, snap: PaddedSnapshot, x: torch.Tensor, *,
                impl: str = "xla", force_ref: bool = False) -> torch.Tensor:
    """Multi-layer GCN; ReLU between layers, the last layer linear."""
    for i, p in enumerate(layers):
        last = i == len(layers) - 1
        x = gcn_layer(p, snap, x, act=None if last else torch.relu,
                      impl=impl, force_ref=force_ref)
    return x


def gcn_forward_weights(layers: list, weights: list, snap: PaddedSnapshot,
                        x: torch.Tensor, *, impl: str = "xla",
                        force_ref: bool = False) -> torch.Tensor:
    """GCN forward with weight matrices supplied from outside (EvolveGCN:
    the evolved ``weights`` replace params["w"] layer by layer)."""
    return gcn_forward([dict(p, w=w) for p, w in zip(layers, weights)], snap,
                       x, impl=impl, force_ref=force_ref)


class StaticGCN:
    """A plain multi-layer GCN: no recurrence, zero state (GenGNN-style
    non-temporal traffic, the serve layer's express lane).

    A "stream" of static snapshots is a batch of independent graphs:
    ``step_stream`` folds the T axis onto the engine's batch axis (every
    slot T = 1; the static kernel refuses anything else) and
    ``step_stream_batched`` folds (B, T) onto (B*T, 1), turning the plan's
    ragged ``lengths`` into per-slot 0/1 liveness. Every level computes
    the same forward; v3 runs all slots in one launch of the static
    stream-engine kernel (csrc/static_engine.cu).
    """

    stream_family = "static_gcn"

    def __init__(self, cfg, impl: str = "xla", n_global: int = 4096):
        assert cfg.dgnn_type == "static"
        self.cfg = cfg
        self.impl = impl
        self.n_global = n_global

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, on the CPU."""
        cfg = self.cfg
        layers, din = [], cfg.in_dim
        for l in range(cfg.n_gnn_layers):
            dout = cfg.out_dim if l == cfg.n_gnn_layers - 1 else cfg.hidden
            layers.append(init_gcn_layer(gen, din, dout,
                                         cfg.edge_dim if l == 0 else 0))
            din = dout
        return {"gcn": layers}

    def init_state(self, params: dict, mode: str = "baseline") -> dict:
        return {}  # stateless

    def step(self, params: dict, state: dict, snap: PaddedSnapshot, *,
             mode: str = "baseline", force_ref: bool = False):
        """One snapshot's GCN forward (``impl="pallas"``: message passing on
        the ELL SpMM kernel). Returns (state, outputs (n_pad, out_dim))."""
        return state, gcn_forward(params["gcn"], snap, snap.node_feat,
                                  impl=self.impl, force_ref=force_ref)

    def _edge_aggs(self, params: dict, snaps: PaddedSnapshot):
        """Per-layer pre-aggregated edge-message term (additive in the ELL
        aggregation, so it factors out of the kernel); zeros for layers
        without edge weights (only layer 0 projects edges)."""
        if params["gcn"][0].get("w_edge") is None:
            return None
        lead = snaps.neigh_eidx.shape[:-2]
        n = snaps.neigh_eidx.shape[-2]
        aggs = []
        for p in params["gcn"]:
            we = p.get("w_edge")
            if we is None:
                aggs.append(snaps.node_feat.new_zeros(
                    (*lead, n, p["w"].shape[0])))
                continue
            aggs.append(kref.ell_spmm(snaps.neigh_eidx, snaps.neigh_coef,
                                      snaps.neigh_eidx, snaps.edge_feat @ we))
        return aggs

    @staticmethod
    def _check_residency(state_residency, buffer_depth):
        # accepted for parity with the stateful families, but a static
        # family has no recurrent store to page
        if state_residency != "vmem" or buffer_depth is not None:
            raise ValueError(
                "state_residency='hbm_paged' is undefined for static "
                "family 'static_gcn': zero StateDefs — there is no "
                "recurrent store to page")

    def stream_args(self, params: dict, state: dict,
                    snaps: PaddedSnapshot) -> tuple:
        """The stream engine's argument list for (B, 1, ...) snapshot slots
        (the order of kernels/ops.stream_steps); ``state`` is empty."""
        del state
        return (snaps.neigh_idx, snaps.neigh_coef, snaps.node_feat,
                snaps.node_mask, [p["w"] for p in params["gcn"]],
                [p["b"] for p in params["gcn"]],
                self._edge_aggs(params, snaps))

    def _launch(self, params: dict, slots: PaddedSnapshot, lengths,
                force_ref: bool):
        dev = params["gcn"][0]["w"].device
        (outs,) = kops.stream_steps_batched(
            self.stream_family, *self.stream_args(params, {}, slots),
            lengths=lengths, force_ref=force_ref, device=dev)
        return outs

    def step_stream(self, params: dict, state: dict, snaps_T: PaddedSnapshot,
                    *, tn=128, td="cfg", state_residency="vmem",
                    buffer_depth=None, force_ref=False):
        """V3: T independent snapshots fold onto the engine's batch axis
        (one launch, T slots of a single T = 1 step each)."""
        del tn, td
        self._check_residency(state_residency, buffer_depth)
        slots = _fold(snaps_T, lambda a: a[:, None])
        return state, self._launch(params, slots, None, force_ref)[:, 0]

    def step_stream_batched(self, params: dict, state: dict,
                            snaps_BT: PaddedSnapshot, *, tn=128, td="cfg",
                            lengths=None, state_residency="vmem",
                            buffer_depth=None, force_ref=False):
        """Batched V3: (B, T) independent snapshots fold onto (B*T, 1);
        ragged ``lengths`` (per-stream T) become per-slot 0/1 liveness, so
        a dead slot outputs zeros. ``state`` passes through untouched."""
        del tn, td
        self._check_residency(state_residency, buffer_depth)
        B, T = snaps_BT.node_mask.shape[:2]
        outs = self._launch(params, *self.fold_slots(snaps_BT, lengths),
                            force_ref)
        return state, outs.reshape(B, T, *outs.shape[2:])

    @staticmethod
    def fold_slots(snaps_BT: PaddedSnapshot, lengths=None):
        """(B, T) snapshots as (B*T, 1) slots, and ragged ``lengths`` as the
        slots' 0/1 liveness (host ints, as the plan carries lengths)."""
        B, T = snaps_BT.node_mask.shape[:2]
        slots = _fold(snaps_BT, lambda a: a.reshape(B * T, 1, *a.shape[2:]))
        if lengths is None:
            return slots, None
        return slots, [int(t < int(n)) for n in lengths for t in range(T)]


def _fold(snaps: PaddedSnapshot, fn) -> PaddedSnapshot:
    """``fn`` applied to every leaf of a snapshot batch."""
    return PaddedSnapshot(**{f.name: fn(getattr(snaps, f.name))
                             for f in dataclasses.fields(PaddedSnapshot)})
