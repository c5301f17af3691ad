"""The port's LM training path computes the JAX package's.

On the CPU, with the JAX package's parameters carried across by
``params.lm_params_from_jax`` and the same numpy batch:

* ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
  the JAX ``loss_fn`` on the reduced phi3-mini (MHA) and qwen2.5-14b (GQA
  group 2, QKV bias), with ``attn_impl`` "xla" and "flash" (the flash
  kernels' plain versions against JAX's Pallas kernels in interpret
  mode), ``remat`` on and off, and one case with ``bwd_bf16``. Tolerances:
  the loss within 1e-3 relative (measured ~1.3e-5); each gradient leaf
  within ``TOL_GRAD`` = 3e-2 of its max |value| (measured at most 1.03e-2
  over these cases: both packages run the layers in bf16 but round at
  other places, e.g. the embedding's scatter-add, so leaves differ by a
  few bf16 ulps, 2^-8 relative each; the margin is 2.9x);
* ``apply_updates`` against the JAX one for fp32, bf16 and int8 moments,
  four steps from the same moments (``params.opt_state_from_jax``):
  parameters and moments within 1e-5, int8 codes at most 1 apart;
  ``schedule`` within 1e-7;
* ``synthetic_lm_batches`` bit for bit against the JAX generator;
* ``CheckpointManager``: round trip (bf16 and int8 leaves too), an async
  save holding the tree as it was at ``save`` while the tree is then
  updated in place, the atomic rename, ``keep_last``, and a checkpoint the
  JAX manager wrote restoring into the port's template;
* ``train``: resume from the latest step, its async step-2 checkpoint
  holding step 2, SIGTERM stopping with a final save, stragglers counted
  at deadline 0;
* ``python -m repro_torch.launch.train --arch phi3-mini-3.8b --steps 3
  --device cpu``;
* the training-only switches of nn/layers: ``set_lowmem_norm`` (norms and
  RoPE against the JAX package's under the same switch, within one bf16
  ulp of max |value|: each package may round the bf16 chain at other
  points) and ``bf16_cotangent`` (its gradient bit for bit).
"""
import dataclasses
import functools
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro import optim as jo
from repro.nn import layers as jlayers
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import synthetic_lm_batches as jax_batches
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch import optim as to
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import synthetic_lm_batches
from repro_torch.nn import layers as tlayers
from repro_torch.params import lm_params_from_jax, opt_state_from_jax
from repro_torch.train import TrainLoopConfig, train

ROOT = Path(__file__).resolve().parents[1]
TOL_LOSS = 1e-3
TOL_GRAD = 3e-2
B, S = 2, 64
# small tiles so the flash kernels' causal tile skip and the chunked loss
# both run at S = 64
RT = dict(loss_chunk=32, flash_bq=32, flash_bk=32, attn_chunk=32)


def _cfgs(arch):
    return (jcfg.reduce_for_smoke(jcfg.ARCHS[arch]),
            tcfg.reduce_for_smoke(tcfg.ARCHS[arch]))


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S + 1)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, impl, bwd_bf16):
    """The JAX reference (remat on; remat does not change its values):
    (params numpy, loss, grad leaves numpy)."""
    jc, _ = _cfgs(arch)
    jrt = jm.RuntimeConfig(attn_impl=impl, bwd_bf16=bwd_bf16, **RT)
    pj, _ = jm.init_params(jc, jrt, jax.random.PRNGKey(1))
    toks = _tokens(jc.vocab_size)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}
    loss, grads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jc, jrt, batch))(pj)
    return (jax.tree.map(np.asarray, pj), float(loss),
            [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])


@pytest.mark.parametrize("arch,impl,remat,bwd_bf16", [
    (arch, impl, remat, False)
    for arch in ("phi3-mini-3.8b", "qwen2.5-14b")
    for impl in ("xla", "flash") for remat in (True, False)
] + [("phi3-mini-3.8b", "flash", True, True)])
def test_loss_and_grads_match_jax(arch, impl, remat, bwd_bf16):
    params_np, want_loss, want_grads = _jax_loss_and_grads(arch, impl,
                                                           bwd_bf16)
    _, tc = _cfgs(arch)
    trt = tm.RuntimeConfig(attn_impl=impl, remat=remat, bwd_bf16=bwd_bf16,
                           **RT)
    pt = lm_params_from_jax(tc, trt, params_np)
    leaves = to.tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.from_numpy(_tokens(tc.vocab_size))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    loss = tm.loss_fn(pt, tc, trt, batch, device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - want_loss) <= TOL_LOSS * abs(want_loss)
    assert len(grads) == len(want_grads)
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape
        err = float(np.abs(got.float().numpy() - want).max())
        assert np.isfinite(err) and err <= TOL_GRAD * np.abs(want).max()


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_apply_updates_matches_jax(state_dtype):
    jc, tc = _cfgs("phi3-mini-3.8b")
    kw = dict(state_dtype=state_dtype, lr=1e-2, warmup_steps=2,
              total_steps=6)
    cfg_j, cfg_t = jo.AdamWConfig(**kw), to.AdamWConfig(**kw)
    pj, _ = jm.init_params(jc, jm.RuntimeConfig(), jax.random.PRNGKey(0))
    oj = jo.init_opt_state(pj, cfg_j)
    params_np = jax.tree.map(np.asarray, pj)
    pt = lm_params_from_jax(tc, tm.RuntimeConfig(), params_np)
    ot = opt_state_from_jax(params_np, jax.tree.map(np.asarray, oj))
    rng = np.random.default_rng(0)
    for _ in range(4):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * 0.1, params_np)
        pj, oj, mj = jo.apply_updates(pj, jax.tree.map(jnp.asarray, g_np),
                                      oj, cfg_j)
        gt = lm_params_from_jax(tc, tm.RuntimeConfig(), g_np)
        pt2, ot2, mt = to.apply_updates(pt, gt, ot, cfg_t)
        assert pt2 is pt and ot2 is ot  # in place
    assert int(ot["step"]) == int(oj["step"]) == 4
    assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= 1e-5 * \
        float(mj["grad_norm"])
    for a, b in zip(jax.tree.leaves(pj), to.tree_leaves(pt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)
    for a, b in zip(oj["m"], ot["m"]):
        if state_dtype == "int8":
            codes = np.asarray(a["q"]).astype(int) - b["q"].numpy()
            assert np.abs(codes).max() <= 1
            np.testing.assert_allclose(b["scale"].numpy(),
                                       np.asarray(a["scale"]), rtol=1e-5,
                                       atol=0)
        else:
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32), atol=1e-5,
                                       rtol=0)
    for a, b in zip(oj["v"], ot["v"]):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=1e-5,
                                   rtol=0)


def test_schedule_matches_jax():
    cfg_j = jo.AdamWConfig(warmup_steps=10, total_steps=100)
    cfg_t = to.AdamWConfig(warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jo.schedule(cfg_j, jnp.asarray(step, jnp.int32)))
        got = float(to.schedule(cfg_t, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7, (step, got, want)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "hubert-xlarge"])
def test_synthetic_batches_are_the_jax_generator_bit_for_bit(arch):
    jc, tc = _cfgs(arch)
    want, got = jax_batches(jc, 3, 16, seed=7), \
        synthetic_lm_batches(tc, 3, 16, seed=7, device="cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        for k in w:
            a = np.asarray(w[k])
            assert g[k].dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(g[k].numpy(), a)


# --------------------------------------------------------- checkpoints ----

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16),
                  {"c": torch.zeros((2, 2), dtype=torch.int32)}],
            "m": to.quantize_blockwise(torch.linspace(-1, 1, 512).reshape(
                2, 256))}


def _leaves_equal(a, b):
    la, lb = to.tree_leaves(a), to.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _held_writes(monkeypatch):
    """Hold every manager's file writes until the returned event is set, so
    that what the caller changes first lands before the write."""
    go, original = threading.Event(), CheckpointManager._write

    def held(self, *args):
        assert go.wait(timeout=60)
        return original(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held)
    return go


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    t = _tree()
    mgr.save(5, t, blocking=True)
    assert _leaves_equal(mgr.restore(5, t), t)


def test_an_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """The loop updates in place right after it saves: what the file holds
    is the tree as it was at ``save``, not as it is when the thread
    writes."""
    mgr = CheckpointManager(str(tmp_path))
    written = _held_writes(monkeypatch)
    t = {"w": torch.zeros(64), "m": [torch.ones(64)]}
    want = {"w": t["w"].clone(), "m": [t["m"][0].clone()]}
    mgr.save(1, t)
    t["w"].add_(1.0)
    t["m"][0].mul_(3.0)
    written.set()
    mgr.wait()
    assert _leaves_equal(mgr.restore(1, t), want)


def test_atomicity_no_partial_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    os.makedirs(tmp_path / "tmp.99", exist_ok=True)  # a crash's debris
    assert mgr.all_steps() == [1]
    assert not (tmp_path / "tmp.1").exists()  # published by the rename
    assert sorted(os.listdir(tmp_path / "step_0000000001")) == [
        "arrays.npz", "meta.json"]


def test_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_a_jax_checkpoint_restores_into_the_port_template(tmp_path):
    jc, tc = _cfgs("phi3-mini-3.8b")
    pj, _ = jm.init_params(jc, jm.RuntimeConfig(), jax.random.PRNGKey(2))
    oj = jo.init_opt_state(pj, jo.AdamWConfig())
    oj = {**oj, "m": [m + 0.5 for m in oj["m"]],
          "step": jnp.asarray(3, jnp.int32)}
    JaxCheckpointManager(str(tmp_path)).save(3, {"params": pj, "opt": oj},
                                             blocking=True)
    pt = tm.init_params(tc, tm.RuntimeConfig(), device="cpu")
    template = {"params": pt, "opt": to.init_opt_state(pt, to.AdamWConfig())}
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    back = mgr.restore(3, template)
    want = lm_params_from_jax(tc, tm.RuntimeConfig(),
                              jax.tree.map(np.asarray, pj))
    assert _leaves_equal(back["params"], want)
    assert all(bool((m == 0.5).all()) for m in back["opt"]["m"])
    assert int(back["opt"]["step"]) == 3


# ---------------------------------------------------------------- loop ----

def _linear_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(8, 1)).astype(np.float32)
    for _ in range(n):
        x = rng.normal(size=(32, 8)).astype(np.float32)
        yield {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}


def _params():
    return {"w": torch.zeros((8, 1))}


OPT = to.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=40,
                     weight_decay=0.0)


def test_train_resumes_from_the_latest_step(tmp_path):
    loop = TrainLoopConfig(total_steps=4, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path))
    params, res = train(_linear_loss, _params(), _batches(4), OPT, loop,
                        device="cpu")
    assert res.final_step == 4 and res.resumed_from is None
    assert len(res.losses) == 4 and res.losses[-1] < res.losses[0]
    loop = dataclasses.replace(loop, total_steps=6)
    params2, res2 = train(_linear_loss, _params(), _batches(6, seed=1), OPT,
                          loop, device="cpu")
    assert res2.resumed_from == 4 and res2.final_step == 6
    assert len(res2.losses) == 2
    saved = CheckpointManager(str(tmp_path)).restore(
        4, {"params": _params(), "opt": to.init_opt_state(_params(), OPT)})
    assert torch.equal(saved["params"]["w"], params["w"])
    assert int(saved["opt"]["step"]) == 4


def test_the_async_step_2_checkpoint_holds_step_2(tmp_path, monkeypatch):
    """The periodic save at step 2 is async; its write is held here until
    step 3 has updated the parameters and moments in place. The checkpoint
    holds them as they were after step 2, read as the inputs of step 3's
    loss."""
    written, seen = _held_writes(monkeypatch), []

    def loss(params, batch):
        seen.append(params["w"].detach().clone())
        if len(seen) == 4:  # step 3's update is done
            written.set()
        return _linear_loss(params, batch)

    loop = TrainLoopConfig(total_steps=4, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path))
    train(loss, _params(), _batches(4), OPT, loop, device="cpu")
    saved = CheckpointManager(str(tmp_path)).restore(
        2, {"params": _params(), "opt": to.init_opt_state(_params(), OPT)})
    assert int(saved["opt"]["step"]) == 2
    assert torch.equal(saved["params"]["w"], seen[2])
    assert not torch.equal(seen[2], seen[3])


def test_sigterm_stops_the_loop_with_a_final_save(tmp_path):
    seen = [0]

    def loss(params, batch):
        seen[0] += 1
        if seen[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return _linear_loss(params, batch)

    loop = TrainLoopConfig(total_steps=10, checkpoint_every=100,
                           checkpoint_dir=str(tmp_path))
    _, res = train(loss, _params(), _batches(10), OPT, loop, device="cpu")
    assert res.final_step == 2
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]


def test_stragglers_are_counted_at_deadline_zero():
    loop = TrainLoopConfig(total_steps=3, straggler_deadline_s=0.0)
    _, res = train(_linear_loss, _params(), _batches(3), OPT, loop,
                   device="cpu")
    assert res.straggler_steps == 3 and len(res.step_times) == 3
    assert all(t > 0 for t in res.step_times)


def test_launch_train_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "phi3-mini-3.8b", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "steps=3 resumed_from=None" in out.stdout


# ------------------------------------------------------------ switches ----

@pytest.mark.parametrize("lowmem", [False, True])
def test_norm_and_rope_follow_the_lowmem_switch(lowmem):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(8)[None].repeat(2, 0)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    wide = tlayers.rms_norm(xt, torch.from_numpy(scale), 1e-5)
    try:
        jlayers.set_lowmem_norm(lowmem)
        tlayers.set_lowmem_norm(lowmem)
        pairs = [(jlayers.rms_norm(xj, jnp.asarray(scale), 1e-5),
                  tlayers.rms_norm(xt, torch.from_numpy(scale), 1e-5)),
                 (jlayers.apply_rope(xj, jnp.asarray(pos), 1e4),
                  tlayers.apply_rope(xt, torch.from_numpy(pos), 1e4))]
    finally:
        jlayers.set_lowmem_norm(False)
        tlayers.set_lowmem_norm(False)
    for want, got in pairs:
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** -8 * np.abs(want).max()
    # the switch changes where the port rounds
    assert torch.equal(pairs[0][1], wide) != lowmem


def test_bf16_cotangent_rounds_the_gradient_as_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    g = (rng.normal(size=(3, 5)) * (1 + 1e-3)).astype(np.float32)
    _, vjp = jax.vjp(jlayers.bf16_cotangent, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tlayers.bf16_cotangent(xt)
    assert torch.equal(y, xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, g)  # the rounding happened
