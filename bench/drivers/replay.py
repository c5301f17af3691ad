"""The replay driver: histories already resident on the card, replayed
through ``repro_torch``'s session API.

Set-up takes each stream through the port's own ingest (renumber,
normalise, pad into the traffic's bucket, stack over T) and onto the
device, as a user replaying history that is already resident. Each call
is ``BoosterSession.run`` (one stream, after ``reset_state``) or
``BoosterSession.run_batched`` (a group of streams, ragged), and returns
its outputs (one a stream) and states unsynchronised, in the layout the
plain reference gives.
"""
from __future__ import annotations


def ingest(pool: list, bucket: dict, device) -> list:
    """Each stream through the port's own ingest (renumber, normalise, pad
    into the bucket, stack over T) and onto the device, as a user replaying
    history that is already resident."""
    from repro_torch.graph.coo import COOSnapshot
    from repro_torch.graph.csr import renumber_and_normalize
    from repro_torch.graph.padding import pad_snapshot, stack_streams

    out = []
    for s in pool:
        padded = [pad_snapshot(renumber_and_normalize(
            COOSnapshot(snap.src, snap.dst, snap.ef, t)), s.feat,
            bucket["n_pad"], bucket["e_pad"], bucket["k_max"])
            for t, snap in enumerate(s.snaps)]
        out.append(stack_streams(padded).to(device))
    return out


def make_session(cell, params: dict, n_global: int, device, inputs=None):
    """The port's session at the cell's model and plan (the replay's
    session needs nothing of ``inputs``)."""
    from repro_torch import api
    from repro_torch.configs.dgnn import DGNNConfig

    cfg = cell.config
    dgnn = DGNNConfig(**cfg["dgnn"], **cfg["widths"])
    b = cell.traffic["bucket"]
    plan = api.plan(dgnn, **cell.plan, n_pad=b["n_pad"], e_pad=b["e_pad"],
                    k_max=b["k_max"])
    return api.BoosterSession(dgnn, plan, n_global=n_global, params=params,
                              device=device)


def make_call(session, padded: list, group: list, port_state):
    """The timed call of one group: its outputs (one a stream) and states
    are returned unsynchronised."""
    if len(group) == 1:
        s = padded[group[0]]

        def run_one():
            session.reset_state()
            outs = session.run(s)
            return [outs], [port_state(session.state)]
        return run_one, "session.run"
    streams = [padded[i] for i in group]

    def run_many():
        states, outs = session.run_batched(streams)
        return outs, [port_state(states, b) for b in range(len(group))]
    return run_many, "session.run_batched"
