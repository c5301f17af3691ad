"""The port's dry-run tooling (``launch/steps.py``, ``roofline/``,
``launch/dryrun.py``, ``launch/dgnn_dryrun.py``) against the JAX
package's, on the CPU.

* ``steps.batch_specs``, ``abstract_opt_state`` and ``abstract_caches``
  give the JAX package's keys, shapes and dtypes over ``ARCHS`` x
  ``SHAPES`` (the port's ``meta`` tensors beside JAX's
  ``ShapeDtypeStruct``s; ``abstract_params`` is pinned in
  ``tests/test_torch_tp.py``).
* ``model_flops`` and ``total_corrections`` equal JAX's numbers;
  ``Roofline``'s terms are JAX's arithmetic with the H100's peaks in
  place of the TPU's (the cases of ``tests/test_sharding_roofline.py``).
* In a subprocess on a fake (2, 4) mesh (``torch``'s fake process group,
  ``meta`` local shards): the collective counter on a row-parallel
  product counts one all-reduce of the output's bytes; the mini dry run
  (the counterpart of ``tests/test_multidevice.py``'s: reduced qwen3, tp
  4, train and decode) counts FLOPs and collective bytes, each parameter,
  optimizer-state and cache leaf's local shard has the shape JAX's
  ``NamedSharding.shard_shape`` gives on a (2, 4) mesh of 8 forced host
  devices (a JAX subprocess), and the record's argument bytes are their
  sum; the DGNN dry run at 64 streams has no collective and the closed
  form's useful FLOPs.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro import optim as jopt
from repro import roofline as jroof
from repro.launch import steps as jsteps
from repro.roofline import corrections as jcorr
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch import optim as topt
from repro_torch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.optim import tree_leaves
from repro_torch.roofline import corrections as tcorr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(jcfg.ARCHS)
SHAPES = sorted(jcfg.SHAPES)


def _jax_layout(tree) -> list:
    return [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(tree)]


def _port_layout(tree) -> list:
    return [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(tree)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_jax(arch, shape):
    jspec, jax_axes = jsteps.batch_specs(jcfg.ARCHS[arch], jcfg.SHAPES[shape])
    tspec, taxes = tsteps.batch_specs(tcfg.ARCHS[arch], tcfg.SHAPES[shape])
    assert list(tspec) == list(jspec)
    assert _port_layout(tspec) == _jax_layout(jspec)
    assert {k: a.names for k, a in taxes.items()} == \
        {k: a.names for k, a in jax_axes.items()}
    assert all(t.device.type == "meta" for t in tspec.values())


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-moe-3b-a800m",
                                  "jamba-v0.1-52b"])
def test_abstract_opt_state_equals_jax(arch, state_dtype):
    rt_kw = dict(tp=16, param_dtype="bf16" if state_dtype == "int8"
                 else "fp32")
    jshapes, jaxes = jsteps.abstract_params(jcfg.ARCHS[arch],
                                            jm.RuntimeConfig(**rt_kw))
    tshapes, taxes = tsteps.abstract_params(tcfg.ARCHS[arch],
                                            tm.RuntimeConfig(**rt_kw))
    jo, _ = jsteps.abstract_opt_state(jshapes, jaxes,
                                      jopt.AdamWConfig(state_dtype=state_dtype))
    to, _ = tsteps.abstract_opt_state(tshapes, taxes,
                                      topt.AdamWConfig(state_dtype=state_dtype))
    assert _port_layout(to) == _jax_layout(jo)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_caches_equal_jax(arch, kv_quant):
    shape = jcfg.SHAPES["decode_32k"]
    kw = dict(tp=16, kv_quant=kv_quant)
    jc, _ = jsteps.abstract_caches(jcfg.ARCHS[arch], jm.RuntimeConfig(**kw),
                                   shape.global_batch, shape.seq_len)
    tc, _ = tsteps.abstract_caches(tcfg.ARCHS[arch], tm.RuntimeConfig(**kw),
                                   shape.global_batch, shape.seq_len)
    # the port keeps a cache's "len" on the host (a real int32 scalar a
    # layer position, as the JAX package's); everything else is meta
    assert _port_layout(tc) == _jax_layout(jc)


# ----------------------------------------------------------- roofline ----

def test_peaks_are_the_h100s():
    assert troof.PEAK_FLOPS == 989e12
    assert troof.HBM_BW == 3.35e12
    assert troof.NVLINK_BW == 450e9
    import repro_torch.roofline.analysis as A
    assert "H100" in A.__doc__ and "InfiniBand" in A.__doc__


def test_roofline_terms_and_bottleneck():
    """tests/test_sharding_roofline.py's case at the H100's peaks."""
    r = troof.Roofline(flops=989e12, bytes_hbm=3.35e12 * 2, bytes_coll=0,
                       chips=256, model_flops=989e12 * 256 * 0.5)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(0.25)
    assert r.useful_ratio == pytest.approx(0.5)


@pytest.mark.parametrize("terms", [(1e12, 2e9, 3e8, 8), (5e15, 1e11, 9e11, 256),
                                   (0.0, 0.0, 0.0, 1)])
def test_roofline_is_jax_arithmetic_with_the_peaks_swapped(terms):
    flops, by, coll, chips = terms
    j = jroof.Roofline(flops=flops, bytes_hbm=by, bytes_coll=coll,
                       chips=chips, model_flops=3 * flops)
    t = troof.Roofline(flops=flops, bytes_hbm=by, bytes_coll=coll,
                       chips=chips, model_flops=3 * flops)
    assert t.t_compute * troof.PEAK_FLOPS == pytest.approx(
        j.t_compute * jroof.PEAK_FLOPS)
    assert t.t_memory * troof.HBM_BW == pytest.approx(j.t_memory * jroof.HBM_BW)
    assert t.t_collective * troof.NVLINK_BW == pytest.approx(
        j.t_collective * jroof.ICI_BW)
    assert t.useful_ratio == j.useful_ratio
    assert sorted(t.to_dict()) == sorted(j.to_dict())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_corrections_equal_jax(arch, shape):
    jc, tc = jcfg.ARCHS[arch], tcfg.ARCHS[arch]
    js, ts = jcfg.SHAPES[shape], tcfg.SHAPES[shape]
    assert troof.model_flops(tc, ts) == jroof.model_flops(jc, js)
    for impl in ("xla", "flash"):
        want = jcorr.total_corrections(jc, js, 16, 2048, 512, attn_impl=impl)
        got = tcorr.total_corrections(tc, ts, 16, 2048, 512, attn_impl=impl)
        assert got == want


def test_model_flops_scales():
    dense = troof.model_flops(tcfg.ARCHS["deepseek-coder-33b"],
                              tcfg.SHAPES["train_4k"])
    assert dense >= 6 * tcfg.ARCHS["deepseek-coder-33b"].param_count() \
        * 256 * 4096
    moe = troof.model_flops(tcfg.ARCHS["llama4-maverick-400b-a17b"],
                            tcfg.SHAPES["train_4k"])
    assert moe < 6 * tcfg.ARCHS["llama4-maverick-400b-a17b"].param_count() \
        * 256 * 4096 / 5


def test_corrections_are_itemized_and_nonnegative():
    c = tcorr.total_corrections(tcfg.ARCHS["mamba2-2.7b"],
                                tcfg.SHAPES["prefill_32k"], 16, 2048, 512)
    assert c["flops"] >= 0 and c["bytes_hbm"] >= 0
    assert "ssd" in {i["site"] for i in c["items"]}
    c2 = tcorr.total_corrections(tcfg.ARCHS["phi3-mini-3.8b"],
                                 tcfg.SHAPES["train_4k"], 16, 2048, 512)
    assert {i["site"] for i in c2["items"]} == {"attention", "loss"}


# -------------------------------------------- the fake mesh (subprocess) ----

PORT_SCRIPT = """
import json, torch
from torch.distributed.tensor import DTensor, Shard, Replicate
from repro_torch.configs import ARCHS, SHAPES, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.api import DEFAULT_RULES, sharding_ctx
from repro_torch.launch import dryrun as D, dgnn_dryrun as G, steps as S
from repro_torch.models import RuntimeConfig
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.roofline import CostCounter

out = {}
mesh = D.fake_mesh((2, 4), ("data", "model"))
# a row-parallel product: x (8, 64) split on K over 'model', w (64, 32)
# split on K: a partial sum, one all-reduce of the (8, 32) fp32 output
x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                       [Replicate(), Shard(1)], run_check=False)
w = DTensor.from_local(torch.empty(16, 32, device="meta"), mesh,
                       [Replicate(), Shard(0)], run_check=False)
c = CostCounter(device="meta")
with c:
    y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
out["rowpar"] = [c.collectives.bytes_by_op, c.collectives.count_by_op,
                 list(y.to_local().shape)]
cfg = reduce_for_smoke(ARCHS["qwen3-32b"])
rt = RuntimeConfig(tp=4, scan_layers=False, attn_chunk=64, moe_impl="ep",
                   loss_chunk=16)
rules = dict(DEFAULT_RULES); rules["embed_fsdp"] = None
with sharding_ctx(mesh, rules):
    p, pax = S.abstract_params(cfg, rt)
    o, oax = S.abstract_opt_state(p, pax, AdamWConfig())
    cs, cax = S.abstract_caches(cfg, rt, 8, 64)
    for name, (t, ax) in {"params": (p, pax), "opt": (o, oax),
                          "caches": (cs, cax)}.items():
        tree = D.fake_tree(t, ax, mesh)
        out[name] = [list(x.to_local().shape) for x in tree_leaves(tree)]
    b, bax = S.batch_specs(cfg, ShapeConfig("mini_train", 64, 8, "train"))
    out["batch_train"] = [list(x.to_local().shape) for x in
                          tree_leaves(D.fake_tree(b, bax, mesh))]
    b, bax = S.batch_specs(cfg, ShapeConfig("mini_dec", 64, 8, "decode"))
    out["batch_decode"] = [list(x.to_local().shape) for x in
                           tree_leaves(D.fake_tree(b, bax, mesh))]
ov = {"rt": {"attn_chunk": 64, "loss_chunk": 16}}
for shape in ("train_4k", "decode_32k"):
    out[shape] = D.run_cell("qwen3-32b", shape, False, ov, mesh_shape=(2, 4),
                            batch=8, seq=64, reduced=True)
out["dgnn"] = G.run("gcrn-m2", 64, "v2", False, mesh_shape=(2, 4))
print("JSON" + json.dumps(out, default=str))
"""

JAX_SCRIPT = """
import json, jax
from repro.configs import ARCHS, reduce_for_smoke
from repro.configs.base import ShapeConfig
from repro.distributed.api import DEFAULT_RULES, sharding_ctx, tree_shardings
from repro.launch import steps as S
from repro.models import RuntimeConfig
from repro.optim import AdamWConfig

mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = reduce_for_smoke(ARCHS["qwen3-32b"])
rt = RuntimeConfig(tp=4, scan_layers=False, attn_chunk=64, moe_impl="ep",
                   loss_chunk=16)
rules = dict(DEFAULT_RULES); rules["embed_fsdp"] = None
out = {}

def local(tree, axes):
    sh = tree_shardings(tree, axes, mesh)
    return [list(s.shard_shape(t.shape)) for t, s in
            zip(jax.tree.leaves(tree), jax.tree.leaves(sh))]

def nbytes(tree, axes):
    sh = tree_shardings(tree, axes, mesh)
    total = 0
    for t, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)):
        n = 1
        for d in s.shard_shape(t.shape):
            n *= d
        total += n * t.dtype.itemsize
    return total

with sharding_ctx(mesh, rules):
    p, pax = S.abstract_params(cfg, rt)
    o, oax = S.abstract_opt_state(p, pax, AdamWConfig())
    cs, cax = S.abstract_caches(cfg, rt, 8, 64)
    out["params"] = local(p, pax)
    out["opt"] = local(o, oax)
    out["caches"] = local(cs, cax)
    bt, btax = S.batch_specs(cfg, ShapeConfig("mini_train", 64, 8, "train"))
    bd, bdax = S.batch_specs(cfg, ShapeConfig("mini_dec", 64, 8, "decode"))
    out["batch_train"] = local(bt, btax)
    out["batch_decode"] = local(bd, bdax)
    out["bytes_train"] = nbytes(p, pax) + nbytes(o, oax) + nbytes(bt, btax)
    out["bytes_decode"] = nbytes(p, pax) + nbytes(cs, cax) + nbytes(bd, bdax)
print("JSON" + json.dumps(out))
"""


def _run(script: str, env_extra: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", **env_extra)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def fake_mesh_runs():
    port = _run(PORT_SCRIPT, {})
    jaxr = _run(JAX_SCRIPT,
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    return port, jaxr


def test_counter_counts_a_row_parallel_all_reduce(fake_mesh_runs):
    port, _ = fake_mesh_runs
    by_op, count, shape = port["rowpar"]
    assert count == {"all-reduce": 1}
    assert by_op == {"all-reduce": 8 * 32 * 4}
    assert shape == [8, 32]


@pytest.mark.parametrize("tree", ["params", "opt", "caches", "batch_train",
                                  "batch_decode"])
def test_local_shards_equal_jax_shard_shapes(fake_mesh_runs, tree):
    port, jaxr = fake_mesh_runs
    # the port's cache "len" is a host scalar a layer, JAX's a replicated
    # (layers,) array: the same shape
    assert port[tree] == jaxr[tree]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_mini_dry_run(fake_mesh_runs, shape):
    port, jaxr = fake_mesh_runs
    rec = port[shape]
    assert rec["status"] == "run" and rec["mesh"] == "2x4"
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["chips"] == 8
    assert rec["collectives"]["bytes_by_op"], "collectives on a 2x4 mesh"
    assert sum(rec["collectives"]["bytes_by_op"].values()) == rl["bytes_coll"] > 0
    want = jaxr["bytes_train" if shape == "train_4k" else "bytes_decode"]
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["memory"]["peak_estimate_bytes"] >= want
    assert rec["corrections"]["added"] == []
    assert {"memory", "collectives", "corrections", "roofline"} <= set(rec)


def test_dgnn_dry_run_has_no_collectives(fake_mesh_runs):
    port, _ = fake_mesh_runs
    rec = port["dgnn"]
    assert rec["collectives"]["bytes_by_op"] == {}
    assert rec["roofline"]["bytes_coll"] == 0
    assert rec["roofline"]["flops"] > 0
    cfg = tcfg.dgnn.DGNN_CONFIGS["gcrn-m2"]
    e_eff, n_eff = 2 * 269 + 118, 118
    useful = 64 * (2 * e_eff * cfg.in_dim + 2 * e_eff * cfg.hidden
                   + 2 * n_eff * (cfg.in_dim + cfg.hidden) * 4 * cfg.hidden)
    assert rec["roofline"]["model_flops"] == useful
