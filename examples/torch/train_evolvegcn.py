"""Train EvolveGCN-O on dynamic link prediction (BC-Alpha-like stream),
on the PyTorch port (the counterpart of ``examples/train_evolvegcn.py``).

The full training substrate on the paper's own model: the fault-tolerant
loop (resume and async checkpoints) and AdamW. Loss: BCE on dot-product
scores of the edges of snapshot t+1 against sampled negatives, predicted
from the V1 embeddings at t. The V1 path is plain PyTorch (edge-parallel
message passing and the matrix-GRU), differentiated by autograd, as the
JAX package differentiates plain XLA: no hand-written kernel is on it.

    PYTHONPATH=src python examples/torch/train_evolvegcn.py [--steps 200]
    PYTHONPATH=src python examples/torch/train_evolvegcn.py --device cpu

On the card unless ``--device cpu``. The default checkpoint directory is
``evolvegcn_torch_ckpt`` under the temporary directory, not the JAX
example's ``/tmp/evolvegcn_ckpt``: the port's ``CheckpointManager``
restores checkpoints the JAX one wrote, so a shared directory would
resume a port run from a JAX run.
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import plan
from repro_torch.configs.dgnn import BC_ALPHA, EVOLVEGCN
from repro_torch.core import build_model, run_plan, stack_time
from repro_torch.graph import (
    generate_temporal_graph,
    pad_snapshot,
    renumber_and_normalize,
    slice_snapshots,
)
from repro_torch.kernels.ops import resolve_device, to_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainLoopConfig, train

WINDOW = 6
N_PAD, E_PAD, K_MAX = 640, 4096, 64
NPAIRS = 256
DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "evolvegcn_torch_ckpt")


def build_batches(tg, ft, snaps, steps, seed=0, device="cuda"):
    """Sliding windows of padded snapshots + link-prediction targets: the
    JAX example's numpy draws in its order (t0, then the negatives, then
    the selected pairs), so the batches are its batches. The window lies
    on ``device``; pos / neg are int64 (NPAIRS, 2) global ids there."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pads = [pad_snapshot(renumber_and_normalize(s), ft, N_PAD, E_PAD, K_MAX)
            for s in snaps]
    for _ in range(steps):
        t0 = rng.integers(0, len(pads) - WINDOW - 1)
        window = stack_time(pads[t0: t0 + WINDOW]).to(dev)
        nxt = pads[t0 + WINDOW]
        # positives: edges of snapshot t0 + WINDOW in the local ids of ITS
        # padding, scored in global id space through the renumber table
        e = int(nxt.n_edges)
        ren = np.asarray(nxt.renumber)
        pos = np.stack([ren[np.asarray(nxt.src)[:e]],
                        ren[np.asarray(nxt.dst)[:e]]], 1)
        neg = rng.integers(0, tg.n_global_nodes, pos.shape)
        sel = rng.integers(0, pos.shape[0], NPAIRS)
        yield {
            "window": window,
            "pos": torch.as_tensor(pos[sel], dtype=torch.int64, device=dev),
            "neg": torch.as_tensor(neg[sel], dtype=torch.int64, device=dev),
            "last_renumber": window.renumber[-1],
            "last_mask": window.node_mask[-1],
        }


def make_loss_fn(model, v1, n_global: int):
    """loss_fn(params, batch) -> scalar: the window through ``v1`` from a
    fresh state, the last step's embeddings scattered into a global
    (n_global + 1, out_dim) table (padded rows to the spare row
    ``n_global`` with zero values, so their duplicate writes agree), then
    softplus BCE on dot-product scores of the positive and negative
    pairs."""

    def loss_fn(params, batch):
        state = model.init_state(params, mode=v1.level)
        _, outs = run_plan(model, params, state, batch["window"], v1)
        emb_local = outs[-1]                       # (n_pad, out_dim)
        ren = batch["last_renumber"].long()
        idx = torch.where(ren >= 0, ren, n_global)
        # out of place: autograd needs the zeros table untouched
        glob = torch.zeros((n_global + 1, emb_local.shape[1]),
                           dtype=torch.float32, device=emb_local.device)
        glob = glob.index_put((idx,),
                              emb_local * batch["last_mask"][:, None])

        def score(pairs):
            return (glob[pairs[:, 0]] * glob[pairs[:, 1]]).sum(-1)

        pos, neg = score(batch["pos"]), score(batch["neg"])
        return F.softplus(-pos).mean() + F.softplus(neg).mean()

    return loss_fn


def setup(device="cuda", seed: int = 0):
    """(tg, feature table, snapshots, model, initial params on ``device``,
    the v1 plan) of the JAX example, the params drawn from ``seed``."""
    dev = resolve_device(device)
    tg, ft = generate_temporal_graph(BC_ALPHA)
    snaps = slice_snapshots(tg, 1.0)
    model = build_model(EVOLVEGCN, n_global=tg.n_global_nodes)
    params0 = to_device(model.init(torch.Generator().manual_seed(seed)), dev)
    return tg, ft, snaps, model, params0, plan(EVOLVEGCN, level="v1")


def optimizer(steps: int) -> AdamWConfig:
    """The example's AdamW over ``steps`` steps."""
    return AdamWConfig(lr=3e-3, weight_decay=0.01, warmup_steps=20,
                       total_steps=steps)


def run(steps: int, ckpt, device="cuda"):
    """Train ``steps`` steps with checkpoints every 50 into ``ckpt`` (None:
    none). Returns (params, TrainResult)."""
    dev = resolve_device(device)
    tg, ft, snaps, model, params, v1 = setup(dev)
    loop = TrainLoopConfig(total_steps=steps, checkpoint_every=50,
                           checkpoint_dir=ckpt)
    return train(make_loss_fn(model, v1, tg.n_global_nodes), params,
                 build_batches(tg, ft, snaps, steps, device=dev),
                 optimizer(steps), loop, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    _, res = run(args.steps, args.ckpt, args.device)
    k = max(1, len(res.losses) // 10)
    print(f"resumed_from={res.resumed_from} steps={res.final_step}")
    print(f"loss: first10={np.mean(res.losses[:k]):.4f} "
          f"last10={np.mean(res.losses[-k:]):.4f}")
    print(f"mean step time: {np.mean(res.step_times[1:])*1e3:.1f} ms; "
          f"stragglers: {res.straggler_steps}")


if __name__ == "__main__":
    main()
