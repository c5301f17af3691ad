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
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.kernels import ops as kops


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
