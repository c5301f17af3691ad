"""End-to-end DGNN serving (the paper's deployment scenario), on
the PyTorch port (the counterpart of ``examples/serve_stream.py``).

Runs both base models (EvolveGCN -> V1/V3, GCRN-M2 -> V2/V3) over both
datasets (BC-Alpha, UCI), with the paper's ablation levels, and prints
the Table IV / Fig. 6 style comparison measured on this host. Everything
goes through the typed plan/execute API: a validated ``StreamPlan`` per
configuration, a ``BoosterSession`` owning params/state, and the serving
engine as a consumer of the session. V3 is the time-fused stream engine:
the server batches snapshots into chunks and the recurrent state (the
node store for GCRN, the evolving weight matrices for EvolveGCN) stays
on the card, in each stream's thread-block cluster, across each chunk.
Batched multi-stream serving is included (--streams N), plus a RAGGED
batch: unequal-length streams in ONE launch via the plan's ``lengths``
capability.

    PYTHONPATH=src python examples/torch/serve_stream.py [--snapshots 32] [--streams 4] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import BoosterSession, plan
from repro_torch.configs.dgnn import BC_ALPHA, DGNN_CONFIGS, UCI
from repro_torch.core import init_states_batched, run_plan_batched, stack_time
from repro_torch.graph import (
    generate_temporal_graph,
    pad_snapshot,
    renumber_and_normalize,
    slice_snapshots,
)
from repro_torch.graph.padding import stack_streams

PAIRS = [("evolvegcn", ("v1", "v3")), ("gcrn-m2", ("v2", "v3"))]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _session(name, p, tg, ft, params, device):
    """A session on plan ``p`` for the model ``name``: params drawn from
    seed 0, or ``params[name]`` where the caller carries them."""
    cfg = DGNN_CONFIGS[name]
    carried = (params or {}).get(name)
    return BoosterSession(
        cfg, p, n_global=tg.n_global_nodes, feat_table=ft, params=carried,
        gen=None if carried is not None else torch.Generator().manual_seed(0),
        device=device)


def run(snapshots: int = 24, streams: int = 4, device="cuda",
        params=None) -> dict:
    """The example's steps; ``params`` ({"evolvegcn", "gcrn-m2"}, each
    optional) replaces the seeded params. Returns every path's outputs,
    keyed by its label."""
    results = {}
    for ds in (BC_ALPHA, UCI):
        tg, ft = generate_temporal_graph(ds)
        snaps = slice_snapshots(tg, 1.0)[:snapshots]
        for name, levels in PAIRS:
            for lv in ("baseline",) + levels:
                session = _session(name, plan(DGNN_CONFIGS[name], level=lv),
                                   tg, ft, params, device)
                outs, stats = session.serve(snaps)
                results[(ds.name, name, lv)] = outs
                print(f"{ds.name:9s} {name:10s} {lv:8s} "
                      f"{stats.mean_latency_ms:8.3f} ms/snapshot "
                      f"(host prep {np.mean(stats.preprocess_ms):.3f} ms, "
                      "overlapped)")

    # batched multi-stream serving: the production throughput axis.
    # level="v3" runs ALL B streams through ONE batched stream-engine
    # launch (a thread-block cluster a stream, its state store on the card)
    ds = BC_ALPHA
    tg, ft = generate_temporal_graph(ds)
    snaps = slice_snapshots(tg, 1.0)[:snapshots]
    pads = [pad_snapshot(renumber_and_normalize(s), ft, 640, 4096, 64)
            for s in snaps]
    sT = stack_time(pads)
    B = streams
    sBT = stack_streams([sT] * B).to(device)
    name = "gcrn-m2"
    cfg = DGNN_CONFIGS[name]
    for lv in ("v2", "v3"):
        p = plan(cfg, level=lv, batch=B)
        session = _session(name, p, tg, ft, params, device)
        states = init_states_batched(session.model, session.params, B,
                                     mode=lv)

        def launch(p=p, session=session, states=states):
            return run_plan_batched(session.model, session.params, states,
                                    sBT, p)[1]

        launch()
        _sync(device)
        t0 = time.perf_counter()
        out = launch()
        _sync(device)
        dt = time.perf_counter() - t0
        results[("batched", lv)] = out.cpu().numpy()
        total = B * snapshots
        launches = ("1 batched stream launch" if lv == "v3"
                    else "a loop over the streams' steps")
        print(f"\nbatched streams [{lv}]: {B} x {snapshots} snapshots in "
              f"{dt*1e3:.1f} ms -> {total/dt:.0f} snapshots/s ({launches})")

    # RAGGED batch: unequal-length streams in ONE launch; the plan's
    # ``lengths`` masks each stream's dead tail in-launch, and the session
    # slices outputs back to true lengths.
    session = _session(name, plan(cfg, level="v3"), tg, ft, params, device)
    lens = [max(snapshots // (i + 1), 2) for i in range(B)]
    ragged = [stack_time(pads[:t]) for t in lens]
    _, outs = session.run_batched(ragged)
    results["ragged"] = [o.cpu().numpy() for o in outs]
    print(f"ragged batch [v3]: lengths {lens} in one launch -> "
          f"per-stream outputs {[o.shape[0] for o in outs]}")

    # multi-tenant server: independent clients, same-bucket chunks from
    # different clients grouped into one batched V3 launch
    n_per = max(snapshots // 2, 2)
    tenants = {f"client{i}": slice_snapshots(tg, 1.0)[i: i + n_per]
               for i in range(streams)}
    session = _session(name, plan(cfg, level="v3", stream_chunk=4), tg, ft,
                       params, device)
    t0 = time.perf_counter()
    _, outs, stats = session.serve_multi(tenants)
    dt = time.perf_counter() - t0
    results["multi"] = outs
    served = sum(len(v) for v in outs.values())
    print(f"multi-tenant v3: {len(tenants)} clients, {served} snapshots in "
          f"{dt*1e3:.1f} ms ({stats.mean_latency_ms:.3f} ms/snapshot, "
          f"host prep overlapped across {len(tenants)} producer threads)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snapshots", type=int, default=24)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.snapshots, args.streams, args.device)


if __name__ == "__main__":
    main()
