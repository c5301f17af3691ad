"""Operations and bytes of EvolveGCN-O on the benchmark's own inputs.

Counted from a stream's COO snapshots and the widths alone, never from a
tensor the program made, so no change to padding, tiling or kernels moves
the count; layers at their true widths (din_l, dout_l). Per snapshot with
n active nodes and e COO edges the GCN's graph has 2e + n directed edges
with self-loops (its ELL lanes):

engine operations, per layer: the aggregation, 2 (2e + n) din_l, the edge
term's add, n din_l, the node product, 2 n din_l dout_l, and the weight's
evolution, two products of (dout_l, din_l) by (din_l, 3 din_l):
12 dout_l din_l^2;
engine bytes, each input read once and each output written once: the
lanes' source and coef (8 bytes a lane), each node's feature row and
mask, its edge term at each layer's input width, its output row, the
snapshot's live flag; and once a stream each layer's weight in and out,
its bias and its GRU's parameters;
step operations: the engine's, plus the edge features' aggregation,
2 (2e + n) De, each layer's edge term, 2 n De din_l, and once a stream
the priming evolution of every layer.
Elementwise gate math is not counted.
"""
from __future__ import annotations

import numpy as np


def layer_dims(w: dict) -> list:
    dims, din = [], w["in_dim"]
    for l in range(w["n_gnn_layers"]):
        dout = w["out_dim"] if l == w["n_gnn_layers"] - 1 else w["hidden"]
        dims.append((din, dout))
        din = dout
    return dims


def count(stream, w: dict) -> dict:
    """{"engine_flops", "engine_bytes", "step_flops"} of one call's pass
    over ``stream`` (a harness ``Stream``) at widths ``w``."""
    dims, de = layer_dims(w), w["edge_dim"]
    evolve = sum(12.0 * dout * din * din for din, dout in dims)
    flops = byts = step = 0.0
    for snap in stream.snaps:
        n = float(np.unique(np.concatenate([snap.src, snap.dst])).size)
        e = float(snap.src.size)
        lanes = 2 * e + n
        f = evolve + sum(2 * lanes * din + n * din + 2 * n * din * dout
                         for din, dout in dims)
        flops += f
        step += f + 2 * lanes * de + sum(2 * n * de * din for din, _ in dims)
        byts += (lanes * 8 + n * (dims[0][0] * 4 + 4)
                 + n * sum(din for din, _ in dims) * 4
                 + n * dims[-1][1] * 4 + 4)
    byts += 4 * sum(2 * din * dout + dout + 2 * din * 3 * din + 3 * din
                    for din, dout in dims)
    return {"engine_flops": flops, "engine_bytes": byts,
            "step_flops": step + evolve}
