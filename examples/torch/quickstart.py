"""Quickstart: serve a dynamic-graph stream through DGNN-Booster V2, on the
PyTorch port (the counterpart of ``examples/quickstart.py``).

Generates a UCI-like temporal graph, slices snapshots on the host, and
streams them through the GCRN-M2 model with the V2 fused dataflow (the
fused GC-LSTM step kernel on the card).

The surface is the typed plan/execute API: build ONE validated
``StreamPlan`` (dataflow level, tiling, serve policy; anything invalid
raises right here, not at launch), bind it to a ``BoosterSession`` that
owns the params and recurrent state, and serve.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import BoosterSession, plan
from repro_torch.configs.dgnn import GCRN_M2, STATIC_GCN, TGN, UCI
from repro_torch.core import stack_time
from repro_torch.graph import (generate_temporal_graph, pad_event_block,
                               slice_snapshots)


def _session(cfg, p, n_global, feat_table, seed, params, device):
    """A session on ``p``: its params drawn from ``seed``, or ``params``
    where the caller carries them (e.g. from the JAX package)."""
    gen = None if params is not None else torch.Generator().manual_seed(seed)
    return BoosterSession(cfg, p, n_global=n_global, feat_table=feat_table,
                          params=params, gen=gen, device=device)


def event_blocks(n_global: int, feat_table):
    """4 batches of 12 timestamped interactions (numpy seed 7)."""
    rng = np.random.default_rng(7)
    blocks = []
    for _ in range(4):
        src = rng.integers(0, n_global, 12)
        dst = (src + rng.integers(1, n_global, 12)) % n_global
        ts = rng.uniform(0.0, 10.0, 12).astype(np.float32)
        blocks.append(pad_event_block(src, dst, ts, feat_table,
                                      n_pad=32, k_max=8))
    return blocks


def run(device="cuda", params=None) -> dict:
    """The quickstart's steps; ``params`` ({"gcrn", "static", "tgn"}, each
    optional) replaces a session's seeded params. Returns each step's
    outputs: {"gcrn": [24 host arrays], "static": [8], "tgn": (4, 32,
    out)}."""
    params = params or {}
    # 1. data: time-stamped COO edges (here: synthetic UCI-like stream)
    tg, feat_table = generate_temporal_graph(UCI)
    snapshots = slice_snapshots(tg, time_splitter=1.0)[:24]

    # 2. plan + session: GCRN-M2 with the V2 (intra-step GNN/RNN fusion)
    #    dataflow, validated at construction time
    session = _session(GCRN_M2, plan(GCRN_M2, level="v2"), tg.n_global_nodes,
                       feat_table, 0, params.get("gcrn"), device)

    # 3. serve: host threads preprocess (CPU tasks), the card consumes
    outputs, stats = session.serve(snapshots)

    print(f"served {len(outputs)} snapshots")
    print(f"mean device latency  : {stats.mean_latency_ms:8.3f} ms/snapshot")
    print(f"mean host preprocess : {np.mean(stats.preprocess_ms):8.3f} "
          "ms/snapshot (overlapped)")
    print(f"end-to-end           : {stats.total_ms:8.1f} ms total")
    print(f"embedding of node 0 @ last snapshot: {outputs[-1][0, :4]}")

    # 4. the other two temporal contracts through the SAME engine: a static
    #    GCN (no recurrence, snapshots fold onto the batch axis) and an
    #    event-driven TGN whose global node memory stays on the card across
    #    ragged event batches.
    static = _session(STATIC_GCN, plan(STATIC_GCN), tg.n_global_nodes,
                      feat_table, 1, params.get("static"), device)
    s_outs, s_stats = static.serve(snapshots[:8])
    print(f"static_gcn (temporal={static.plan.temporal!r}): "
          f"served {len(s_outs)} independent snapshots, "
          f"{s_stats.mean_latency_ms:.3f} ms/snapshot")

    G = tg.n_global_nodes
    blocks = event_blocks(G, feat_table)
    tgn = _session(TGN, plan(TGN, level="v3"), G, feat_table, 2,
                   params.get("tgn"), device)
    t_outs = tgn.run(stack_time(blocks))
    print(f"tgn (temporal={tgn.plan.temporal!r}): "
          f"{len(blocks)} event batches -> outputs {tuple(t_outs.shape)}, "
          f"memory store ({G}, {TGN.hidden}) resident across batches")
    return {"gcrn": outputs, "static": s_outs, "tgn": t_outs.cpu().numpy()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
