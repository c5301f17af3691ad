"""Production-mesh dry run: trace every (arch x shape x mesh) cell on a
fake mesh (the counterpart of ``repro.launch.dryrun``, which lowers and
compiles on forced host devices).

For each cell, in one process:
  - start a fake process group of 256 (16x16) or 512 (2x16x16) ranks
    (``torch.testing._internal.distributed.fake_pg``: collectives return
    at once, nothing is sent) and build the production mesh on it;
  - resolve the runtime config (the JAX package's: FSDP + int8 moments
    for the big archs, sequence-sharded KV for long_500k);
  - make the parameters, optimizer state, caches and batch as DTensors
    by their ``Axes`` whose local shards are ``meta`` tensors (shapes and
    dtypes, no storage; the host scalars a step reads, a cache's "len"
    and the optimizer's step, stay real);
  - run the real train / prefill / decode step (``launch.steps``) on them
    under ``roofline.CostCounter``, which counts each op on this rank's
    local shards, and the flash kernel as its shape-only stand-in;
  - record memory (argument bytes exact from the local shards, a peak
    estimate), the collectives by op, the corrections and the roofline
    at the H100's peaks to JSON.

Traced, not extrapolated: the whole model runs unrolled, every layer and
every trip of the attention / SSD / loss chunk loops is counted, so of
the JAX package's closed-form corrections only the flash kernel's is
added (the record itemises all and names the one added). No fallback: a
missing fake backend, or a process group of another size, fails the run.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--jobs 4]    # every cell, subprocesses
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k \\
      --mesh 1x1 --batch 2 --seq 2048 --overrides '{"rt": {"attn_impl": "flash"}}'
"""
import argparse
import dataclasses
import json
import logging
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs import ARCHS, SHAPES, cell_status, get_config
from repro_torch.configs import reduce_for_smoke
from repro_torch.distributed.api import (DEFAULT_RULES, Axes, named_sharding,
                                         sharding_ctx, tree_map2)
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import RuntimeConfig
from repro_torch.nn.attention import flash_shapes_only
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.roofline import (CostCounter, Roofline, collective_bytes,
                                  cost_analysis_dict, model_flops)
from repro_torch.roofline.corrections import (flash_correction,
                                              total_corrections)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                       "dryrun_torch")

FSDP_THRESHOLD = 8e9        # params; above this shard weights over 'data'
INT8_THRESHOLD = 100e9      # params; above this quantize optimizer moments
HBM_BYTES = 80e9            # one H100's memory
META = torch.device("meta")


def resolve_runtime(cfg, shape, overrides: dict | None = None) -> tuple[RuntimeConfig, AdamWConfig, dict]:
    n = cfg.param_count()
    fsdp = n > FSDP_THRESHOLD
    big = n > INT8_THRESHOLD
    rt = RuntimeConfig(
        tp=16,
        scan_layers=False,           # unrolled: exact per-layer accounting
        remat=True,
        attn_chunk=2048,
        moe_impl="ep",
        fsdp=fsdp,
        long_ctx=(shape.name == "long_500k"),
        loss_chunk=512,
        param_dtype="bf16" if big else "fp32",
        grad_accum=8 if big else 1,
    )
    opt = AdamWConfig(state_dtype="int8" if big else "fp32")
    rules = dict(DEFAULT_RULES)
    if not fsdp:
        rules["embed_fsdp"] = None
    if overrides:
        import dataclasses as _dc

        if overrides.get("rt"):
            rt = _dc.replace(rt, **overrides["rt"])
        rules.update(overrides.get("rules", {}))
        if overrides.get("opt"):
            opt = _dc.replace(opt, **overrides["opt"])
        if overrides.get("norm_lowmem"):
            from repro_torch.nn.layers import set_lowmem_norm

            set_lowmem_norm(True)
        if overrides.get("ssd_bf16"):
            from repro_torch.nn.mamba2 import set_ssd_bf16

            set_ssd_bf16(True)
    return rt, opt, rules


# ---------------------------------------------------------- fake mesh ----


def fake_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of as many
    ranks (this process is rank 0). Raises where the fake backend cannot
    be registered or another process group exists: never a smaller mesh."""
    world = 1
    for s in shape:
        world *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks exists; the dry run needs a "
                f"fake group of {world} (run it in a process of its own)")
    else:
        try:
            from torch.testing._internal.distributed.fake_pg import FakeStore
        except ImportError as e:
            raise RuntimeError(
                "the dry run needs torch's fake process group "
                "(torch.testing._internal.distributed.fake_pg), which this "
                f"torch lacks: {e}") from e
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if tuple(shape) in ((16, 16), (2, 16, 16)) and names == (
            ("data", "model") if len(shape) == 2 else ("pod", "data", "model")):
        return make_production_mesh(multi_pod=len(shape) == 3, device="cpu")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _stride(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _fake_dtensor(t, ax: Axes, mesh):
    """A DTensor of ``t``'s shape and dtype, placed by ``ax`` on ``mesh``,
    whose local shard is a ``meta`` tensor; a host tensor (a cache's
    "len", the optimizer's step: the step reads them on the host) stays
    real, replicated."""
    sh = named_sharding(t.shape, ax.names, mesh)
    if t.device.type != "meta":
        return DTensor.from_local(t, mesh, sh.placements, run_check=False)
    local = list(t.shape)
    for i, p in enumerate(sh.placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device=META),
                              mesh, sh.placements, run_check=False,
                              shape=t.shape, stride=_stride(t.shape))


def fake_tree(meta_tree, axes_tree, mesh):
    return tree_map2(lambda t, ax: _fake_dtensor(t, ax, mesh), meta_tree,
                     axes_tree)


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree of DTensors."""
    total = 0
    for t in tree_leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _trace_once(cfg, shape, rt, opt_cfg, rules, mesh) -> dict:
    """Run one step on meta DTensors under a CostCounter; its counts."""
    t0 = time.time()
    with sharding_ctx(mesh, rules), flash_shapes_only():
        pshapes, paxes = S.abstract_params(cfg, rt)
        params = fake_tree(pshapes, paxes, mesh)
        bspecs, baxes = S.batch_specs(cfg, shape)
        batch = fake_tree(bspecs, baxes, mesh)
        args = {"params": params, "batch": batch}
        if shape.kind == "train":
            oshapes, oaxes = S.abstract_opt_state(pshapes, paxes, opt_cfg)
            args["opt_state"] = fake_tree(oshapes, oaxes, mesh)
        elif shape.kind == "decode":
            cshapes, caxes = S.abstract_caches(cfg, rt, shape.global_batch,
                                               shape.seq_len)
            args["caches"] = fake_tree(cshapes, caxes, mesh)
        arg_bytes = local_bytes(args)
        counter = CostCounter(device=META)
        with counter:
            counter.track(args)
            if shape.kind == "train":
                fn = S.make_train_step_fn(cfg, rt, opt_cfg, device=META)
                fn(params, args["opt_state"], batch)
            elif shape.kind == "prefill":
                S.make_prefill_fn(cfg, rt, device=META)(params, batch)
            else:
                S.make_decode_fn(cfg, rt, device=META)(
                    params, args["caches"], batch)
    ca = cost_analysis_dict(counter)
    coll = collective_bytes(counter)
    return {
        "trace_s": time.time() - t0,
        "flops": ca["flops"], "bytes": ca["bytes accessed"],
        "coll_bytes": float(coll.total_bytes),
        "coll_by_op": dict(coll.bytes_by_op),
        "coll_counts": dict(coll.count_by_op),
        "argument_bytes": arg_bytes, "peak_estimate_bytes": counter.peak,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None, mesh_shape: tuple | None = None,
             batch: int | None = None, seq: int | None = None,
             reduced: bool = False) -> dict:
    """One dry-run cell: the whole step traced once on the fake mesh.
    ``mesh_shape`` (data, model) replaces the production mesh, and its
    model axis ``rt.tp`` unless ``overrides`` set it; ``batch`` / ``seq``
    replace the shape's; ``reduced`` takes ``reduce_for_smoke``. All
    numbers are PER DEVICE but ``model_flops`` (global)."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_for_smoke(cfg)
    if overrides and overrides.get("cfg"):
        cfg = dataclasses.replace(cfg, **overrides["cfg"])
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    mesh_name = "x".join(map(str, mesh_shape))
    status = cell_status(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": status, "batch": shape.global_batch,
           "seq": shape.seq_len, "reduced": reduced}
    if status != "run":
        return rec
    mesh = fake_mesh(mesh_shape, names)
    chips = mesh.size()
    rt, opt_cfg, rules = resolve_runtime(cfg, shape, overrides)
    if mesh_shape[-1] != 16 and "tp" not in (overrides or {}).get("rt", {}):
        rt = dataclasses.replace(rt, tp=mesh_shape[-1])
    m = _trace_once(cfg, shape, rt, opt_cfg, rules, mesh)
    rec["trace_s"] = m["trace_s"]
    rec["accounting"] = ("traced: every layer and every chunk-loop trip "
                         "counted on the local shards (no extrapolation)")
    rec["runtime"] = dataclasses.asdict(rt)
    rec["opt_state_dtype"] = opt_cfg.state_dtype
    rec["memory"] = {
        "argument_size_in_bytes": int(m["argument_bytes"]),
        "peak_estimate_bytes": int(m["peak_estimate_bytes"]),
        "peak_is_estimate": ("the most bytes the step's arguments and the "
                             "live outputs of its ops held at once, with "
                             "no allocator, fusion or workspace"),
        "per_device_bytes": int(m["peak_estimate_bytes"]),
        "fits_80GB": bool(m["peak_estimate_bytes"] < HBM_BYTES),
    }
    corr = total_corrections(cfg, shape, rt.tp, rt.attn_chunk, rt.loss_chunk,
                             attn_impl=rt.attn_impl, flash_bq=rt.flash_bq,
                             flash_bk=rt.flash_bk)
    added = []
    add_flops = add_bytes = 0.0
    if rt.attn_impl == "flash" and not shape.is_decode:
        fc = flash_correction(cfg, shape, rt.tp, rt.flash_bq, rt.flash_bk)
        add_flops, add_bytes = fc.flops, fc.bytes_hbm
        added.append("flash_attention")
    corr["added"] = added
    corr["added_flops"] = add_flops
    corr["added_bytes_hbm"] = add_bytes
    corr["not_added"] = ("attention / ssd / loss: the trace counts every "
                         "trip of their loops")
    rl = Roofline(flops=m["flops"] + add_flops / chips,
                  bytes_hbm=m["bytes"] + add_bytes / chips,
                  bytes_coll=m["coll_bytes"], chips=chips,
                  model_flops=model_flops(cfg, shape))
    rec.update(
        measured={"flops": m["flops"], "bytes": m["bytes"],
                  "coll_bytes": m["coll_bytes"]},
        corrections=corr,
        collectives={"bytes_by_op": m["coll_by_op"],
                     "count_by_op": m["coll_counts"]},
        roofline=rl.to_dict(),
    )
    return rec


def cell_out_path(arch, shape_name, multi_pod, out_dir: str | None = None) -> str:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    tag = "mp" if multi_pod else "sp"
    return os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")


def _mesh_arg(text: str) -> tuple:
    return tuple(int(x) for x in text.lower().split("x"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--overrides", default=None,
                    help="JSON runtime overrides (hillclimb experiments)")
    ap.add_argument("--tag", default=None, help="suffix for the output file")
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="a (data x model) mesh in place of the production "
                         "one, e.g. 2x4 or 1x1")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduce_for_smoke config")
    ap.add_argument("--out", default=None,
                    help="the record's path (default results/dryrun_torch/)")
    args = ap.parse_args()

    if args.all:
        import subprocess

        cells = []
        for arch in sorted(ARCHS):
            for sn in SHAPES:
                for mp in (False, True):
                    cells.append((arch, sn, mp))
        procs: list = []
        failures = []
        for arch, sn, mp in cells:
            out = cell_out_path(arch, sn, mp)
            if os.path.exists(out):
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", sn] + (["--multi-pod"] if mp else [])
            while len(procs) >= args.jobs:
                for p in list(procs):
                    if p[0].poll() is not None:
                        procs.remove(p)
                        if p[0].returncode != 0:
                            failures.append(p[1])
                time.sleep(2)
            procs.append((subprocess.Popen(cmd, env={**os.environ}), (arch, sn, mp)))
            print("launched", arch, sn, "mp" if mp else "sp", flush=True)
        for p, cell in procs:
            if p.wait() != 0:
                failures.append(cell)
        print("failures:", failures)
        return 1 if failures else 0

    overrides = json.loads(args.overrides) if args.overrides else None
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, overrides,
                       mesh_shape=args.mesh, batch=args.batch, seq=args.seq,
                       reduced=args.reduced)
    except (ValueError, TypeError, KeyError, RuntimeError) as e:
        # the expected cell failures: config resolution errors
        # (ValueError/TypeError/KeyError) and tracing errors (a sharding
        # DTensor cannot propagate is a RuntimeError). Anything else — OOM,
        # bad interpreter state — should crash the sweep loudly.
        logging.warning("dry-run cell %s/%s failed: %s: %s",
                        args.arch, args.shape, type(e).__name__, e)
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multi_pod else "16x16",
               "status": "error", "traceback": traceback.format_exc()}
    out = args.out or cell_out_path(args.arch, args.shape, args.multi_pod)
    if args.tag:
        out = out.replace(".json", f"__{args.tag}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    print(json.dumps({k: rec.get(k) for k in
                      ("arch", "shape", "mesh", "status", "trace_s")},
                     indent=None))
    if rec["status"] == "error":
        print(rec["traceback"][-3000:])
        return 1
    if rec["status"].startswith("skip"):
        return 0
    print("memory:", json.dumps(rec["memory"]))
    print("collectives:", json.dumps(rec["collectives"]))
    print("roofline:", json.dumps(rec.get("roofline", {}), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
