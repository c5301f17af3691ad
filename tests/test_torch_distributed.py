"""The port's collectives (``repro_torch.distributed``, the expert-parallel
MoE) against the JAX package's, on the CPU.

The port runs SPMD on ``gloo`` ranks spawned by ``torch_dist_ranks.spawn``
(8 ranks for the compressed all-reduce, 4 for the rest); the JAX package
runs the same numpy inputs under ``shard_map`` in one subprocess with 8
forced host devices (the main test process keeps seeing one device).

* ``compressed_all_reduce`` within 1e-6 of ``compressed_psum`` (value and
  error-feedback residual); over 8 steps of error feedback the mean is
  within 0.05 of the exact mean (``tests/test_multidevice.py``'s check);
  ``bf16_all_reduce`` equal to the rounded mean;
* ``make_compressed_grad_fn`` on 4 ranks: the loss within 1e-6 of the
  JAX one, the gradients within one quantization step (int8), within
  bf16 rounding (bf16), within 1e-6 (plain mean);
* the GPipe ``pipeline`` over 4 stages against ``reference_stack`` and the
  JAX pipeline (1e-5);
* the EP MoE on a (2, 2) mesh, with and without ``fsdp``, within 2e-2 of
  the dense path and of the JAX ep path (ample capacity, nothing
  dropped); on a world-1 host mesh at tp 1 within one bf16 ulp of the JAX
  ep path under its ``make_host_mesh()``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro import configs as jcfg
from repro.distributed.api import sharding_ctx as jctx
from repro.launch.mesh import make_host_mesh as jhost
from repro.nn import moe as jmoe
from repro_torch import configs as tcfg
from repro_torch.distributed.api import sharding_ctx
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.nn import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP = 2.0 ** -8

JAX_SCRIPT = """
import sys
import numpy as np, jax, jax.numpy as jnp, dataclasses
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import ARCHS, reduce_for_smoke
from repro.distributed.api import sharding_ctx
from repro.distributed.compression import (compressed_psum, init_residuals,
                                           make_compressed_grad_fn)
from repro.distributed.pipeline import pipeline
from repro.nn import moe as M
inp = dict(np.load(sys.argv[1]))
out = {}
devs = jax.devices()
mesh8 = jax.make_mesh((8,), ("data",))
f = jax.jit(shard_map(lambda x, r: compressed_psum(x, r, "data"),
                      mesh=mesh8, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")), check_rep=False))
x = jnp.asarray(inp["comp_x"])
y, r = f(x, jnp.zeros_like(x))
out["comp_y"], out["comp_r"] = np.asarray(y), np.asarray(r)
mesh4 = jax.make_mesh((4,), ("data",), devices=devs[:4])
loss_fn = lambda p, b: jnp.mean((jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]
                                 - b["y"]) ** 2)
params = {"w1": jnp.asarray(inp["g_w1"]), "w2": jnp.asarray(inp["g_w2"])}
batch = {"x": jnp.asarray(inp["g_x"]), "y": jnp.asarray(inp["g_y"])}
for scheme in ("int8", "bf16", "mean"):
    g, res, loss = make_compressed_grad_fn(loss_fn, mesh4, scheme=scheme)(
        params, init_residuals(params), batch)
    out[f"{scheme}_loss"] = np.asarray(loss)
    for k in g:
        out[f"{scheme}_{k}"] = np.asarray(g[k])
pmesh = jax.make_mesh((4, 2), ("stage", "data"))
block = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
out["pipe"] = np.asarray(pipeline(block, pmesh, n_stages=4,
                                  n_micro=inp["pp_x"].shape[0])(
    {"w": jnp.asarray(inp["pp_w"]), "b": jnp.asarray(inp["pp_b"])},
    jnp.asarray(inp["pp_x"])))
cfg = dataclasses.replace(reduce_for_smoke(ARCHS["granite-moe-3b-a800m"]),
                          n_experts=4, top_k=2)
mp = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "w_gate", "w_up",
                                                "w_down")}
xm = jnp.asarray(inp["moe_x"], jnp.bfloat16)
emesh = jax.make_mesh((2, 2), ("data", "model"), devices=devs[:4])
for fsdp in (False, True):
    with sharding_ctx(emesh):
        fn = jax.jit(lambda p, x: M.moe_block(p, cfg, x, impl="ep", fsdp=fsdp,
                                              cf_send=4.0, cf_local=4.0))
        out[f"ep_fsdp{int(fsdp)}"] = np.asarray(fn(mp, xm), np.float32)
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(
        tcfg.reduce_for_smoke(tcfg.ARCHS["granite-moe-3b-a800m"]),
        n_experts=4, top_k=2)
    d, f = cfg.d_model, cfg.d_ff
    nrm = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "comp_x": nrm(8, 1000),            # not whole 256-blocks
        "fb_x": nrm(8, 1024),
        "g_w1": nrm(6, 16) * 0.5, "g_w2": nrm(16, 3) * 0.5,
        "g_x": nrm(8, 6), "g_y": nrm(8, 3),
        "pp_w": nrm(4, 16, 16) / 4.0, "pp_b": nrm(4, 16) * 0.1,
        "pp_x": nrm(6, 8, 16),
        "moe_router": nrm(d, 4) * 0.02, "moe_w_gate": nrm(4, d, f) * 0.02,
        "moe_w_up": nrm(4, d, f) * 0.02, "moe_w_down": nrm(4, f, d) * 0.02,
        "moe_x": nrm(4, 16, d),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, the port's 8-rank and 4-rank outputs). The
    JAX subprocess and the port's ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         str(tmp / "inputs.npz"), str(tmp / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        comp = R.spawn(R.compression_ranks, 8, tmp, inp)
        four = R.spawn(R.four_rank_paths, 4, tmp, inp)
        _, err = proc.communicate(timeout=R.TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    return inp, dict(np.load(tmp / "jax.npz")), comp, four


def _np(t):
    return t.detach().float().numpy()


def test_compressed_all_reduce_matches_compressed_psum(runs):
    inp, jx, comp, _ = runs
    for rank, out in enumerate(comp):
        np.testing.assert_allclose(_np(out["y"]), jx["comp_y"][rank],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(out["r"]), jx["comp_r"][rank],
                                   atol=1e-6, rtol=0)
    # every rank holds the same mean, within a quantization step of exact
    exact = inp["comp_x"].mean(axis=0)
    for out in comp[1:]:
        assert torch.equal(out["y"], comp[0]["y"])
    step = np.abs(inp["comp_x"]).max() / 127.0
    assert np.abs(_np(comp[0]["y"]) - exact).max() <= step


def test_compressed_all_reduce_error_feedback(runs):
    """Averaged over 8 steps the compressed mean tends to the exact mean
    (the check of tests/test_multidevice.py)."""
    inp, _, comp, _ = runs
    exact = inp["fb_x"].mean(axis=0)
    err = np.abs(_np(comp[0]["fb_mean"]) - exact).max() / (
        np.abs(exact).max() + 1e-9)
    assert err < 0.05, err


def test_bf16_all_reduce_is_the_rounded_mean(runs):
    inp, _, comp, _ = runs
    rounded = torch.from_numpy(inp["comp_x"]).to(torch.bfloat16).float()
    want = rounded.sum(0).numpy() / 8
    # summed in bf16: within 7 roundings of the partial sums
    bound = 7 * ULP * np.abs(rounded.numpy()).sum(0).max() / 8
    for out in comp:
        assert np.abs(_np(out["bf16"]) - want).max() <= bound
        assert torch.equal(out["bf16"], comp[0]["bf16"])


@pytest.mark.parametrize("scheme", ["int8", "bf16", "mean"])
def test_compressed_grad_fn_matches_jax(runs, scheme):
    _, jx, _, four = runs
    for out in four:
        np.testing.assert_allclose(_np(out[f"{scheme}_loss"]),
                                   jx[f"{scheme}_loss"], atol=1e-6, rtol=0)
        for k in ("w1", "w2"):
            got, want = _np(out[f"{scheme}_{k}"]), jx[f"{scheme}_{k}"]
            tol = {"int8": float(out[f"qstep_{k}"]) * 1.0001,
                   "bf16": ULP * np.abs(want).max() * 2,
                   "mean": 1e-6}[scheme]
            assert np.abs(got - want).max() <= tol, (k, scheme)
    # the plain mean is the same on every rank
    for out in four[1:]:
        assert torch.equal(out[f"{scheme}_w1"], four[0][f"{scheme}_w1"])


def test_int8_grad_residual_is_the_local_quantization_error(runs):
    """Each rank keeps its own residual: the gap between its local
    gradient and the quantized code it sent (|r| <= half a step)."""
    _, _, _, four = runs
    for out in four:
        for k in ("w1", "w2"):
            r = _np(out[f"int8_res_{k}"])
            assert np.abs(r).max() <= float(out[f"qstep_{k}"]) / 2 * 1.0001
    assert not torch.equal(four[0]["int8_res_w1"], four[1]["int8_res_w1"])


def test_pipeline_matches_reference_and_jax(runs):
    _, jx, _, four = runs
    for out in four:
        assert np.abs(_np(out["pipe"]) - _np(out["pipe_ref"])).max() <= 1e-5
        assert np.abs(_np(out["pipe"]) - jx["pipe"]).max() <= 1e-5


@pytest.mark.parametrize("fsdp", [0, 1], ids=["replicated", "fsdp"])
def test_ep_moe_on_a_2x2_mesh(runs, fsdp):
    _, jx, _, four = runs
    dense = _np(four[0]["dense"])
    scale = np.abs(dense).max() + 1e-9
    for out in four:
        ep = _np(out[f"ep_fsdp{fsdp}"])
        assert int(out[f"dropped_fsdp{fsdp}"].sum()) == 0
        assert np.abs(ep - dense).max() / scale < 2e-2
        assert np.abs(ep - jx[f"ep_fsdp{fsdp}"]).max() / scale < 2e-2
        # every rank holds the whole output
        assert torch.equal(out[f"ep_fsdp{fsdp}"], four[0][f"ep_fsdp{fsdp}"])


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "jamba-v0.1-52b"])
def test_ep_moe_at_tp1_matches_jax_within_an_ulp(host_mesh, name):
    jc = jcfg.reduce_for_smoke(jcfg.ARCHS[name])
    tc = tcfg.reduce_for_smoke(tcfg.ARCHS[name])
    pj, _ = jmoe.init_moe(jax.random.PRNGKey(3), jc, 1)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    x = np.random.default_rng(2).normal(size=(2, 13, jc.d_model)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    stats = {}
    with sharding_ctx(host_mesh):
        got = tmoe.moe_block(pt, tc, xt, impl="ep", stats=stats)
    with jctx(jhost()):
        want = jax.jit(lambda p, v: jmoe.moe_block(p, jc, v, impl="ep"))(
            pj, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert np.abs(got.float().numpy() - want).max() <= ULP * np.abs(
        want).max()
    assert len(stats["dropped"]) == 1
