"""DGNN production-scale dry run: the paper's technique on the pod mesh
(the counterpart of ``repro.launch.dgnn_dryrun``).

A single BC-Alpha snapshot cannot fill a card; the production axis is
BATCHED STREAMS: B independent dynamic graphs advance one snapshot per
step, the streams sharded over ('pod', 'data'). The step is traced on a
fake mesh as the LM dry run traces (``launch.dryrun``: ``meta`` local
shards, ``roofline.CostCounter``): parameters replicated, the recurrent
state and the snapshots split by "stream", and each rank runs its local
streams through the plain batched step (``torch.func.vmap`` of the
model's ``step`` at its dataflow level, plain versions, on each rank's
local blocks, as ``ops._shard_batch`` splits a batch). Streams never
communicate, so no collective is expected; the snapshot's "feat" name
(features over 'model' for wide variants) is kept in ``snapshot_specs``,
and the step keeps features whole on each rank. The record has the LM
cells' layout.

  python -m repro_torch.launch.dgnn_dryrun [--model gcrn-m2] [--streams 4096]
"""
import argparse
import json
import os
import sys
import time
import warnings

import torch
from torch.func import vmap

from repro_torch.configs.dgnn import DGNN_CONFIGS
from repro_torch.distributed.api import (DEFAULT_RULES, Axes, named_sharding,
                                         sharding_ctx)
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.launch.dryrun import (META, OUT_DIR, fake_mesh, fake_tree,
                                      local_bytes)
from repro_torch.roofline import (CostCounter, Roofline, collective_bytes,
                                  cost_analysis_dict)


def snapshot_specs(b: int, n_pad: int, e_pad: int, k_max: int, din: int,
                   de: int, mesh):
    """``meta`` tensors + shardings of a stream-batched PaddedSnapshot
    (and the Axes tree they resolve)."""
    fields = {
        "src": ((b, e_pad), torch.int32, ("stream", None)),
        "dst": ((b, e_pad), torch.int32, ("stream", None)),
        "coef": ((b, e_pad), torch.float32, ("stream", None)),
        "edge_feat": ((b, e_pad, de), torch.float32, ("stream", None, None)),
        "neigh_idx": ((b, n_pad, k_max), torch.int32, ("stream", None, None)),
        "neigh_coef": ((b, n_pad, k_max), torch.float32, ("stream", None, None)),
        "neigh_eidx": ((b, n_pad, k_max), torch.int32, ("stream", None, None)),
        "node_feat": ((b, n_pad, din), torch.float32, ("stream", None, "feat")),
        "node_mask": ((b, n_pad), torch.float32, ("stream", None)),
        "renumber": ((b, n_pad), torch.int32, ("stream", None)),
        "n_nodes": ((b,), torch.int32, ("stream",)),
        "n_edges": ((b,), torch.int32, ("stream",)),
    }
    sds, shards, axes = {}, {}, {}
    for k, (shape, dtype, names) in fields.items():
        sds[k] = torch.empty(shape, dtype=dtype, device=META)
        shards[k] = named_sharding(shape, names, mesh)
        axes[k] = Axes(*names)
    return PaddedSnapshot(**sds), PaddedSnapshot(**shards), axes


def _fields(snap: PaddedSnapshot) -> dict:
    return {k: getattr(snap, k) for k in snap.__dataclass_fields__}


def run(model_name: str, streams: int, mode: str, multi_pod: bool,
        n_global: int = 640, mesh_shape: tuple | None = None) -> dict:
    # n_global is PER-STREAM here: each stream is an independent small
    # dynamic graph (its own node-state store); the production axis is the
    # stream count, not one giant graph.
    from repro_torch.core import build_model

    cfg = DGNN_CONFIGS[model_name]
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    mesh = fake_mesh(mesh_shape, names)
    chips = mesh.size()
    model = build_model(cfg, n_global=n_global)
    rec = {"arch": f"dgnn-{model_name}", "shape": f"streams_{streams}",
           "mesh": "x".join(map(str, mesh_shape)), "status": "run",
           "mode": mode}
    # the batched step splits streams only (see the module docstring)
    rules = dict(DEFAULT_RULES, feat=None)
    t0 = time.time()
    with sharding_ctx(mesh, rules):
        real = model.init(torch.Generator().manual_seed(0))
        pmeta = _tree_meta(real)
        params = fake_tree(pmeta, _tree_axes(pmeta, lambda t: (None,) * t.dim()),
                           mesh)
        smeta = _tree_meta(model.init_state(pmeta, mode=mode))
        smeta = _tree_apply(lambda t: torch.empty((streams, *t.shape),
                                                  dtype=t.dtype, device=META),
                            smeta)
        state = fake_tree(smeta, _tree_axes(
            smeta, lambda t: ("stream",) + (None,) * (t.dim() - 1)), mesh)
        snap_meta, _, snap_axes = snapshot_specs(
            streams, 640, 4096, 64, cfg.in_dim, cfg.edge_dim, mesh)
        snap = fake_tree(_fields(snap_meta), snap_axes, mesh)

        def one(p, st, fields):
            return model.step(p, st, PaddedSnapshot(**fields), mode=mode,
                              force_ref=True)

        def local(p, st, fields):
            with warnings.catch_warnings():
                # index_copy_ has no batching rule: vmap loops over streams
                warnings.simplefilter("ignore", UserWarning)
                return vmap(one, in_dims=(None, 0, 0))(p, st, fields)

        counter = CostCounter(device=META)
        with counter:
            counter.track((params, state, snap))
            # each rank's blocks: its streams (the rules split nothing
            # else), the parameters whole
            local(*_tree_apply(lambda t: t.to_local(), (params, state, snap)))
    rec["trace_s"] = time.time() - t0
    arg_bytes = local_bytes((params, state, snap))
    rec["memory"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "peak_estimate_bytes": int(counter.peak),
        "peak_is_estimate": ("the most bytes the step's arguments and the "
                             "live outputs of its ops held at once"),
        "per_device_bytes": int(counter.peak),
        "fits_80GB": bool(counter.peak < 80e9),
    }
    ca = cost_analysis_dict(counter)
    coll = collective_bytes(counter)
    # useful flops: MP (2*e*d) + NT/gates matmuls per stream per step
    e_eff, n_eff = 2 * 269 + 118, 118  # UCI-scale avg (edges incl reverse+loops)
    if model_name == "gcrn-m2":
        useful = streams * (2 * e_eff * cfg.in_dim + 2 * e_eff * cfg.hidden
                            + 2 * n_eff * (cfg.in_dim + cfg.hidden) * 4 * cfg.hidden)
    else:
        useful = streams * (2 * e_eff * cfg.in_dim
                            + 2 * n_eff * cfg.in_dim * cfg.hidden * 2)
    rl = Roofline(flops=ca["flops"], bytes_hbm=ca["bytes accessed"],
                  bytes_coll=float(coll.total_bytes), chips=chips,
                  model_flops=float(useful))
    rec["roofline"] = rl.to_dict()
    rec["collectives"] = {"bytes_by_op": dict(coll.bytes_by_op),
                          "count_by_op": dict(coll.count_by_op)}
    return rec


def _tree_apply(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_apply(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_apply(fn, v) for v in tree)
    return fn(tree)


def _tree_meta(tree):
    return _tree_apply(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device=META), tree)


def _tree_axes(tree, names):
    return _tree_apply(lambda t: Axes(*names(t)), tree)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gcrn-m2", choices=sorted(DGNN_CONFIGS))
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--mode", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="a (data x model) mesh in place of the production "
                         "one, e.g. 2x4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    mode = args.mode or DGNN_CONFIGS[args.model].dataflow
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    rec = run(args.model, args.streams, mode, args.multi_pod,
              mesh_shape=mesh_shape)
    tag = "mp" if args.multi_pod else "sp"
    out = args.out or os.path.join(
        OUT_DIR, f"dgnn-{args.model}__streams_{args.streams}__{tag}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    print(json.dumps(rec.get("roofline"), indent=2))
    print("memory:", rec.get("memory"))
    print("collectives:", rec.get("collectives"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
