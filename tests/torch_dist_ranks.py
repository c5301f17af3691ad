"""Multi-rank runs of the port's collectives on the CPU (``gloo``).

``spawn(body, world, tmp_path, inputs)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn), each joining a ``gloo`` group through a
``file://`` store under ``tmp_path`` (no TCP port, so runs in parallel
test workers never collide), calls ``body(rank, world, inputs)`` and saves
what it returns (a dict of tensors) to ``tmp_path``; ``inputs`` reach the
ranks through a file there. The parent waits with
a timeout, kills what is left, and returns each rank's dict. A rank that
raises writes its traceback, which the parent raises with.

The rank bodies below import no JAX: the tests compare their results with
the JAX package's, computed in a subprocess with forced host devices.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 300


def _rank_main(rank, world, store, out_dir, body):
    try:
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                            weights_only=False)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            out = body(rank, world, inputs)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(body, world: int, tmp_path, inputs: dict,
          timeout: float = TIMEOUT_S) -> list:
    """Run ``body`` on ``world`` gloo ranks; returns their outputs."""
    out_dir = str(tmp_path / f"{body.__name__}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    # through a file: arguments go down each child's pipe, which the
    # parent fills only as fast as the children start (one at a time)
    torch.save(inputs, os.path.join(out_dir, "inputs.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, out_dir, body))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errs = [open(os.path.join(out_dir, f)).read()
            for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
    if errs:
        raise RuntimeError("a rank failed:\n" + errs[0])
    if alive:
        raise TimeoutError(f"{len(alive)} of {world} ranks still ran after "
                           f"{timeout} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------- rank bodies ----

def compression_ranks(rank, world, inp):
    """compressed_all_reduce of x[rank] (one step from a zero residual, and
    8 steps of error feedback), bf16_all_reduce and the plain mean."""
    from repro_torch.distributed.compression import (bf16_all_reduce,
                                                     compressed_all_reduce)

    x = _t(inp["comp_x"])[rank]
    y, r = compressed_all_reduce(x, torch.zeros_like(x))
    xf = _t(inp["fb_x"])[rank]
    res = torch.zeros_like(xf)
    acc = torch.zeros_like(xf)
    for _ in range(8):
        yf, res = compressed_all_reduce(xf, res)
        acc += yf
    return {"y": y, "r": r, "fb_mean": acc / 8, "bf16": bf16_all_reduce(x)}


def _mlp_loss(p, b):
    return torch.mean((torch.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2)


def four_rank_paths(rank, world, inp):
    """On 4 ranks: make_compressed_grad_fn (int8, bf16, mean) with each
    rank's quantization step, the 4-stage pipeline, and the EP MoE on a
    (2, 2) mesh with and without fsdp."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.api import sharding_ctx
    from repro_torch.distributed.pipeline import pipeline, reference_stack
    from repro_torch.nn import moe as M

    out = {}
    params = {"w1": _t(inp["g_w1"]), "w2": _t(inp["g_w2"])}
    batch = {"x": _t(inp["g_x"]), "y": _t(inp["g_y"])}
    for scheme in ("int8", "bf16", "mean"):
        fn = C.make_compressed_grad_fn(_mlp_loss, scheme=scheme)
        grads, res, loss = fn(params, C.init_residuals(params), batch)
        out[f"{scheme}_loss"] = loss
        for k in grads:
            out[f"{scheme}_{k}"] = grads[k]
            out[f"{scheme}_res_{k}"] = res[k]
    # the int8 quantization step of each leaf: its largest shared scale
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    step = batch["x"].shape[0] // world
    local = {k: v[rank * step:(rank + 1) * step] for k, v in batch.items()}
    grads = torch.autograd.grad(
        _mlp_loss(dict(zip(params, leaves)), local), leaves)
    for k, g in zip(params, grads):
        s = C._absmax_scale(C._blocks(g)).max()
        dist.all_reduce(s, op=dist.ReduceOp.MAX)
        out[f"qstep_{k}"] = s
    # the GPipe schedule over 4 stages
    stage_mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    sp = {"w": _t(inp["pp_w"]), "b": _t(inp["pp_b"])}
    xs = _t(inp["pp_x"])
    block = lambda p, x: torch.tanh(x @ p["w"] + p["b"])
    out["pipe"] = pipeline(block, stage_mesh, 4, xs.shape[0])(sp, xs)
    out["pipe_ref"] = reference_stack(block, sp, xs)
    # the expert-parallel MoE over (data 2, model 2)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["granite-moe-3b-a800m"]),
                              n_experts=4, top_k=2)
    mp_ = {k: _t(inp[f"moe_{k}"]) for k in ("router", "w_gate", "w_up",
                                             "w_down")}
    x = _t(inp["moe_x"]).to(torch.bfloat16)
    out["dense"] = M.moe_block(mp_, cfg, x, impl="dense").float()
    for fsdp in (False, True):
        stats = {}
        with sharding_ctx(mesh):
            y = M.moe_block(mp_, cfg, x, impl="ep", fsdp=fsdp, cf_send=4.0,
                            cf_local=4.0, stats=stats)
        out[f"ep_fsdp{int(fsdp)}"] = y.float()
        out[f"dropped_fsdp{int(fsdp)}"] = torch.stack(stats["dropped"])
    return out


def restore_and_tokens(rank, world, inp):
    """Elastic restore of a checkpoint directory onto a (1, 2) mesh, and
    the synthetic tokens under a (2, 1) mesh: each rank's local shards."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.distributed.api import Axes, sharding_ctx

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    template = {k: torch.zeros(inp[f"ck_{k}"].shape, dtype=torch.float32)
                for k in ("a", "b", "c")}
    axes = {"a": Axes("embed", "ffn"), "b": Axes("vocab"),
            "c": Axes("batch", None)}
    got = CheckpointManager(inp["ck_dir"]).restore(inp["ck_step"], template,
                                                   axes=axes, mesh=mesh)
    out = {f"ck_{k}": v.to_local() for k, v in got.items()}
    out.update({f"ck_{k}_placements": str(v.placements)
                for k, v in got.items()})
    cfg = reduce_for_smoke(ARCHS["qwen2.5-14b"])
    data_mesh = init_device_mesh("cpu", (2, 1),
                                 mesh_dim_names=("data", "model"))
    with sharding_ctx(data_mesh):
        b = next(synthetic_lm_batches(cfg, 4, 16, seed=5, device="cpu"))
    out.update({f"tok_{k}": v.to_local() for k, v in b.items()})
    return out


def _leaf_list(tree) -> list:
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _case_cfg(case):
    import dataclasses

    from repro_torch.configs import ARCHS, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(ARCHS[case["arch"]]),
                               **case["cfg"])


def _lm_case(case, mesh, out, key):
    """One architecture's prefill, two decode steps and loss + gradients,
    under ``mesh`` (DTensor parameters and caches by their Axes trees) and,
    with ``mesh`` None, unsharded; results under ``key``."""
    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.distributed.api import (distribute, sharding_ctx,
                                             tree_map2, tree_shardings)
    from repro_torch.models import lm

    cfg = _case_cfg(case)
    rt = lm.RuntimeConfig(**case["rt"])
    # detached: the gradients below must not mark the caller's tensors
    params = lm._tree_map(lambda t: t.detach(), case["params"])
    if mesh is None:
        import contextlib
        ctx, place = contextlib.nullcontext(), (lambda tree, axes: tree)
    else:
        ctx = sharding_ctx(mesh)

        def place(tree, axes):
            return tree_map2(distribute, tree, tree_shardings(tree, axes, mesh))
    with ctx:
        p = place(params, lm.param_axes(cfg, rt))
        out[f"{key}:prefill"] = _full(lm.prefill_step(
            p, cfg, rt, case["batch"], device="cpu"))
        caches = place(lm.init_caches(cfg, rt, case["dec"].shape[0], 8,
                                      device="cpu"), lm.cache_axes(cfg, rt))
        for i in range(case["dec"].shape[1]):
            logits, caches = lm.decode_step(p, cfg, rt, case["dec"][:, i:i + 1],
                                            caches, device="cpu")
            out[f"{key}:decode{i}"] = _full(logits)
        leaves = _leaf_list(p)
        for t in leaves:
            t.requires_grad_(True)
        batch = dict(case["batch"], targets=case["targets"])
        loss = lm.loss_fn(p, cfg, rt, batch, device="cpu")
        grads = torch.autograd.grad(loss, leaves)
        out[f"{key}:loss"] = _full(loss).detach()
        for i, g in enumerate(grads):
            out[f"{key}:grad{i}"] = _full(g)


def lm_mesh_ranks(rank, world, inp):
    """The LM under a (data, model) mesh of ``world`` ranks: each case of
    ``inp["cases"]`` sharded (and, on one rank, also unsharded in this
    process, for the bitwise check); the collectives of one prefill; the
    flash path on local blocks against the unsharded flash; and one
    apply_updates step, fp32 and int8, on given gradients."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.distributed.api import (distribute, named_sharding,
                                             sharding_ctx, tree_map2,
                                             tree_shardings)
    from repro_torch.models import lm
    from repro_torch.nn import attention as ATT
    from repro_torch.optim import (AdamWConfig, apply_updates, init_opt_state,
                                   opt_state_axes)
    from repro_torch.roofline import CostCounter

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", inp["mesh"], mesh_dim_names=("data", "model"))
    out = {}
    for case in inp["cases"]:
        _lm_case(case, mesh, out, case["name"])
        if world == 1 and case["rt"].get("moe_impl") != "ep":
            _lm_case(case, None, out, case["name"] + ":plain")
    # the collectives of one prefill (counted on this rank)
    col = inp.get("collectives")
    if col is not None:
        case = next(c for c in inp["cases"] if c["name"] == col)
        cfg = _case_cfg(case)
        rt = lm.RuntimeConfig(**case["rt"])
        with sharding_ctx(mesh):
            p = tree_map2(distribute, case["params"], tree_shardings(
                case["params"], lm.param_axes(cfg, rt), mesh))
            counter = CostCounter()
            with counter:
                logits = lm.prefill_step(p, cfg, rt, case["batch"], device="cpu")
        out["coll_bytes"] = dict(counter.collectives.bytes_by_op)
        out["coll_count"] = dict(counter.collectives.count_by_op)
        out["logits_placements"] = str(logits.placements)
    # flash on each rank's (batch, heads) block
    q, k, v = (inp["flash"][n] for n in ("q", "k", "v"))
    want = ATT.flash_attention(q, k, v, causal=True, bq=16, bk=16)
    with sharding_ctx(mesh):
        on_mesh = lambda t, *names: distribute(t, named_sharding(
            t.shape, names, mesh))
        got = ATT.flash_attention(on_mesh(q, "batch", None, "heads", None),
                                  on_mesh(k, "batch", None, "kv_heads", None),
                                  on_mesh(v, "batch", None, "kv_heads", None),
                                  causal=True, bq=16, bk=16)
        out["flash"] = got.full_tensor()
        out["flash_placements"] = str(got.placements)
    out["flash_plain"] = want
    # one AdamW step on the given gradients, fp32 and int8 moments
    upd = inp.get("update")
    if upd is not None:
        cfg = reduce_for_smoke(ARCHS[upd["arch"]])
        rt = lm.RuntimeConfig()
        axes = lm.param_axes(cfg, rt)
        for sd in ("fp32", "int8"):
            opt = AdamWConfig(state_dtype=sd)
            with sharding_ctx(mesh):
                sh = tree_shardings(upd["params"], axes, mesh)
                p = tree_map2(lambda t, s: distribute(t.clone(), s),
                              upd["params"], sh)
                g = tree_map2(distribute, upd["grads"], sh)
                state = init_opt_state(p, opt)
                p, state, metrics = apply_updates(p, g, state, opt)
                p, state, _ = apply_updates(p, g, state, opt)
            out[f"upd_{sd}:params"] = [_full(t) for t in _leaf_list(p)]
            out[f"upd_{sd}:m"] = [
                {k: _full(v) for k, v in m.items()} if isinstance(m, dict)
                else _full(m) for m in state["m"]]
            out[f"upd_{sd}:v"] = [_full(t) for t in state["v"]]
            out[f"upd_{sd}:gnorm"] = metrics["grad_norm"]
            if sd == "int8":
                out["upd_axes_opt"] = [str(x) for x in _leaf_list(
                    opt_state_axes(axes, opt)["m"])][:4]
    return out
