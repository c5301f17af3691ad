"""The serve driver: tenants' raw COO histories through the port's serve
engine, ``BoosterSession.serve_multi``.

The serve engine reads one global node-feature table a session, so the
pool's streams are moved into disjoint ranges of one global id space over
one table (``make_pool``): stream b's ids are shifted by the global sizes
of the streams before it. The plain reference is handed that same pool.

Set-up wraps each snapshot as the port's ``COOSnapshot``, held on the
host: nothing is renumbered, padded or uploaded before a call. Each call
is one ``serve_multi`` over its group's streams, every tenant from a
fresh state and with its whole history as an iterator, so the serve
layer's host preprocessing, its tick composition and its state pool are
inside the timed call. ``layout`` lays a kept call's host outputs out as
the reference gives them, once the window has closed.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.harness import streams as _streams


def make_pool(traffic: dict, seed: int, in_dim: int, edge_dim: int) -> list:
    """The traffic's pool (``streams.generate_pool``) in one global id
    space: each stream's snapshots with its ids shifted past the streams
    before it, and one feature table, the streams' tables in pool order."""
    pool = _streams.generate_pool(traffic, seed, in_dim, edge_dim)
    feat = np.concatenate([s.feat for s in pool])
    out, off = [], 0
    for s in pool:
        snaps = [_streams.Snapshot(x.src + off, x.dst + off, x.ef)
                 for x in s.snaps]
        out.append(_streams.Stream(s.name, s.dataset, feat.shape[0], feat,
                                   snaps))
        off += s.n_global
    return out


def ingest(pool: list, bucket: dict, device) -> tuple:
    """(each stream's snapshots as the port's ``COOSnapshot`` on the host,
    the global feature table): raw input, nothing prepared."""
    from repro_torch.graph.coo import COOSnapshot

    snaps = [[COOSnapshot(x.src, x.dst, x.ef, t) for t, x in enumerate(s.snaps)]
             for s in pool]
    return snaps, pool[0].feat


def make_session(cell, params: dict, n_global: int, device, inputs: tuple):
    """The port's session at the cell's model and plan, over the pool's
    feature table."""
    from repro_torch import api
    from repro_torch.configs.dgnn import DGNNConfig

    cfg = cell.config
    dgnn = DGNNConfig(**cfg["dgnn"], **cfg["widths"])
    b = cell.traffic["bucket"]
    plan = api.plan(dgnn, **cell.plan, n_pad=b["n_pad"], e_pad=b["e_pad"],
                    k_max=b["k_max"])
    return api.BoosterSession(dgnn, plan, n_global=n_global,
                              feat_table=inputs[1], params=params,
                              device=device)


def make_call(session, inputs: tuple, group: list, port_state):
    """The timed call of one group: one ``serve_multi``, a tenant a
    stream, each from a fresh state. Returns each tenant's outputs (a list
    of host arrays, one a snapshot) and final state."""
    snaps = inputs[0]

    def serve():
        states, outs, _ = session.serve_multi(
            {b: iter(snaps[j]) for b, j in enumerate(group)})
        return ([outs[b] for b in range(len(group))],
                [port_state(states[b]) for b in range(len(group))])
    return serve, "session.serve_multi"


def layout(outs: list, states: list, device) -> tuple:
    """A call's outputs as the reference gives them: one (T, n_pad, out)
    tensor a stream on ``device``, its padding rows as served."""
    return ([torch.from_numpy(np.stack(o)).to(device) for o in outs],
            states)
