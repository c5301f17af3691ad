"""Operations and bytes of GCRN-M2 on the benchmark's own inputs.

Counted from a stream's COO snapshots and the widths alone, never from a
tensor the program made, so no change to padding, tiling or kernels moves
the count. Per snapshot with n active nodes and e COO edges the GCN's
graph has 2e + n directed edges with self-loops (its ELL lanes):

engine operations: the two aggregations, 2 (2e + n)(din + H), the edge
messages' adds, 2e din, and the gate products, 2 n (din + H) 4H;
engine bytes, each input read once and each output written once: the
lanes' source, coef and edge index (12 bytes a lane), each node's feature
row, row id and mask, its h and c rows read from the store and written
back, its h output row, the 2e edge-message rows; and once a stream the
LSTM's weights;
step operations: the engine's, plus the edge projection ef @ w_edge,
2 (2e) De din, and the output head, 2 n H out.
Elementwise gate math is not counted.
"""
from __future__ import annotations

import numpy as np


def count(stream, w: dict) -> dict:
    """{"engine_flops", "engine_bytes", "step_flops"} of one call's pass
    over ``stream`` (a harness ``Stream``) at widths ``w``."""
    din, H, out, de = w["in_dim"], w["hidden"], w["out_dim"], w["edge_dim"]
    flops = byts = step = 0.0
    for snap in stream.snaps:
        n = float(np.unique(np.concatenate([snap.src, snap.dst])).size)
        e = float(snap.src.size)
        lanes = 2 * e + n
        f = 2 * lanes * (din + H) + 2 * e * din + 2 * n * (din + H) * 4 * H
        flops += f
        step += f + 2 * (2 * e) * de * din + 2 * n * H * out
        byts += (lanes * 12 + n * (din * 4 + 4 + 4) + n * 2 * H * 4 * 2
                 + n * H * 4 + 2 * e * din * 4)
    byts += (din * 4 * H + H * 4 * H + 4 * H) * 4
    return {"engine_flops": flops, "engine_bytes": byts, "step_flops": step}
