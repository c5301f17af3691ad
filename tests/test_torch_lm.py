"""The port's LM serving path computes the JAX package's.

On the CPU, at the six attention-only architectures' ``reduce_for_smoke``
sizes, with the JAX package's parameters carried across by
``params.lm_params_from_jax`` and the same numpy inputs:

* ``prefill_step`` logits at ``attn_impl`` "xla" (full / chunked) and
  "flash" (the flash kernel's plain version; flash_bq = flash_bk = 16 at
  S = 32, so the causal tile skip runs; JAX's flash kernel in interpret
  mode); HuBERT covers the non-causal path and embeddings input;
* ``decode_step`` caches and logits, with and without the int8 KV cache;
* ``param_dtype="bf16"``;
* ``generate``: each step's logits, and the tokens where JAX's top-2
  margin is larger than the tolerance.

Both packages compute in bf16 with fp32 softmax and norms, but round at
other places (a bf16 einsum's accumulation, silu), so logits agree to
``TOL`` = 2e-2 of max |logits| over the real vocabulary (measured about
5e-3). The configs and ``RuntimeConfig`` are pinned field by field, the
parameter layout at full width for all six (JAX by ``jax.eval_shape``, the
port on the ``meta`` device: nothing is allocated), and the refusal of a
full KV cache. The MoE / SSM architectures are held against the JAX
package in ``tests/test_torch_ssm_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.serve import lm_serve as jserve
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.models import lm as tlm
from repro_torch.params import lm_params_from_jax
from repro_torch.serve import generate

TOL = 2e-2
ATTN_ONLY = ["deepseek-coder-33b", "phi3-mini-3.8b", "qwen2.5-14b",
             "qwen3-32b", "internvl2-26b", "hubert-xlarge"]


def _smoke(name):
    return jcfg.reduce_for_smoke(jcfg.ARCHS[name]), \
        tcfg.reduce_for_smoke(tcfg.ARCHS[name])


def _params(name, **rt_kw):
    """(JAX cfg, port cfg, JAX params, port params, JAX rt, port rt)."""
    jc, tc = _smoke(name)
    jrt, trt = jm.RuntimeConfig(**rt_kw), tm.RuntimeConfig(**rt_kw)
    pj, _ = jm.init_params(jc, jrt, jax.random.PRNGKey(1))
    pt = lm_params_from_jax(tc, trt, jax.tree.map(np.asarray, pj))
    return jc, tc, pj, pt, jrt, trt


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        a = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}
    a = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}


def _close(got, want, vocab):
    """Logits over the real vocabulary within TOL of max |want|."""
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= TOL * scale, (err, scale)


# ------------------------------------------------------------- configs ----

def test_archs_and_shapes_are_the_jax_registry():
    assert tcfg.list_archs() == jcfg.list_archs()
    for name in jcfg.list_archs():
        assert dataclasses.asdict(tcfg.get_config(name)) == \
            dataclasses.asdict(jcfg.get_config(name))
        assert dataclasses.asdict(tcfg.reduce_for_smoke(tcfg.ARCHS[name])) \
            == dataclasses.asdict(jcfg.reduce_for_smoke(jcfg.ARCHS[name]))
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert tcfg.runnable_cells() == jcfg.runnable_cells()
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("nope")


def test_runtime_config_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jm.RuntimeConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tm.RuntimeConfig)]
    assert tf == jf


def _layout(tree):
    """{path: (shape, dtype name)} of a params tree (JAX ShapeDtypeStruct
    or torch leaves)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}.{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            name = str(t.dtype).removeprefix("torch.")
            out[path] = (tuple(t.shape), {"float32": "float32",
                                          "bfloat16": "bfloat16"}[name])
    walk(tree, "")
    return out


@pytest.mark.parametrize("param_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ATTN_ONLY)
def test_init_params_layout_at_full_width(name, param_dtype):
    cfg_j, cfg_t = jcfg.ARCHS[name], tcfg.ARCHS[name]
    want = jax.eval_shape(
        lambda key: jm.init_params(
            cfg_j, jm.RuntimeConfig(param_dtype=param_dtype), key)[0],
        jax.random.PRNGKey(0))
    got = tm.init_params(cfg_t, tm.RuntimeConfig(param_dtype=param_dtype),
                         device="meta")
    assert _layout(got) == _layout(want)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        got, is_leaf=torch.is_tensor))


def test_lm_params_from_jax_checks_keys_shapes_and_dtypes():
    jc, tc, pj, pt, _, trt = _params("qwen2.5-14b")
    pnp = jax.tree.map(np.asarray, pj)
    assert pt["blocks"][0]["attn"]["wq"].dtype == torch.float32
    bad = jax.tree.map(lambda a: a, pnp)
    bad["blocks"][0]["attn"].pop("bq")
    with pytest.raises(ValueError, match="expected keys"):
        lm_params_from_jax(tc, trt, bad)
    bad = jax.tree.map(lambda a: a, pnp)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(tc, trt, bad)
    with pytest.raises(ValueError, match="dtype float32, expected bfloat16"):
        lm_params_from_jax(tc, tm.RuntimeConfig(param_dtype="bf16"), pnp)


# ------------------------------------------------------------- prefill ----

@pytest.mark.parametrize("name", ATTN_ONLY)
def test_prefill_matches_jax(name):
    jc, tc, pj, pt, jrt, trt = _params(name, flash_bq=16, flash_bk=16)
    bj, bt = _batch(jc, 2, 32)
    for impl in ("xla", "flash"):
        want = jm.prefill_step(pj, jc, dataclasses.replace(
            jrt, attn_impl=impl), bj)
        got = tm.prefill_step(pt, tc, dataclasses.replace(
            trt, attn_impl=impl), bt, device="cpu")
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got.numpy(), want, jc.vocab_size)


def test_prefill_in_bf16_params_and_the_chunked_path():
    jc, tc, pj, pt, jrt, trt = _params("qwen2.5-14b", param_dtype="bf16",
                                       attn_chunk=16, flash_bq=16,
                                       flash_bk=16)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(
        pt, is_leaf=torch.is_tensor))
    bj, bt = _batch(jc, 2, 32, seed=1)
    want = jm.prefill_step(pj, jc, jrt, bj)  # S 32 > chunk 16: chunked
    got = tm.prefill_step(pt, tc, trt, bt, device="cpu")
    _close(got.numpy(), want, jc.vocab_size)
    flash = tm.prefill_step(pt, tc, dataclasses.replace(
        trt, attn_impl="flash"), bt, device="cpu")
    _close(flash.numpy(), want, jc.vocab_size)


# -------------------------------------------------------------- decode ----

@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_caches_and_logits_match_jax(kv_quant):
    jc, tc, pj, pt, jrt, trt = _params("qwen2.5-14b", kv_quant=kv_quant)
    cj = jm.init_caches(jc, jrt, 2, 8)
    ct = tm.init_caches(tc, trt, 2, 8, device="cpu")
    assert set(ct[0]) == set(cj[0])
    rng = np.random.default_rng(2)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = jm.decode_step(pj, jc, jrt, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(pt, tc, trt, torch.from_numpy(tok), ct,
                                device="cpu")
        _close(lt.numpy(), lj, jc.vocab_size)
        np.testing.assert_array_equal(ct[0]["len"].numpy(),
                                      np.asarray(cj[0]["len"]))
        assert int(ct[0]["len"][0]) == step + 1
        for key in ("k", "v"):
            got, want = ct[0][key], np.asarray(cj[0][key])
            assert got.shape == want.shape
            if kv_quant:
                # int8 codes of bf16 keys: a code may sit one step apart
                assert got.dtype == torch.int8
                assert np.abs(got.numpy().astype(int) - want).max() <= 1
                np.testing.assert_allclose(
                    ct[0][f"{key}_s"].float().numpy(),
                    np.asarray(cj[0][f"{key}_s"], np.float32), rtol=1e-2)
            else:
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           atol=TOL * np.abs(want).max())
        # slots past the written ones stay empty
        assert not ct[0]["k"][:, :, step + 1:].any()


def test_decode_matches_prefill_of_the_same_prompt():
    """The logits after the last prompt token through the caches are the
    prefill's of the whole prompt (both in the port)."""
    _, tc, _, pt, _, trt = _params("phi3-mini-3.8b")
    _, bt = _batch(tc, 2, 8, seed=3)
    prefill = tm.prefill_step(pt, tc, dataclasses.replace(
        trt, attn_impl="flash", flash_bq=8, flash_bk=8), bt, device="cpu")
    caches = tm.init_caches(tc, trt, 2, 16, device="cpu")
    for i in range(8):
        logits, caches = tm.decode_step(pt, tc, trt, bt["tokens"][:, i:i + 1],
                                        caches, device="cpu")
    _close(logits.numpy(), prefill.numpy(), tc.vocab_size)


def test_generate_matches_jax():
    jc, tc, pj, pt, jrt, trt = _params("qwen2.5-14b")
    prompt = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, 4)).astype(np.int32)
    want = np.asarray(jserve.generate(pj, jc, jrt, jnp.asarray(prompt), 4,
                                      16))
    got = generate(pt, tc, trt, torch.from_numpy(prompt), 4, 16,
                   device="cpu").numpy()
    assert got.shape == want.shape == (2, 4) and got.dtype == np.int32
    # each step's logits, both fed JAX's sequence
    seq = np.concatenate([prompt, want], axis=1)
    cj = jm.init_caches(jc, jrt, 2, 16)
    ct = tm.init_caches(tc, trt, 2, 16, device="cpu")
    agree = np.ones(2, bool)  # no low-margin step yet, per sequence
    for i in range(prompt.shape[1] + 3):
        tok = seq[:, i:i + 1]
        lj, cj = jm.decode_step(pj, jc, jrt, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(pt, tc, trt, torch.from_numpy(tok), ct,
                                device="cpu")
        _close(lt.numpy(), lj, jc.vocab_size)
        j = i - prompt.shape[1] + 1  # the generated token this step picks
        if j < 0:
            continue
        lj = np.asarray(lj)[:, -1, :jc.vocab_size]
        top2 = np.sort(lj, axis=-1)[:, -2:]
        agree &= (top2[:, 1] - top2[:, 0]) > TOL * np.abs(lj).max()
        assert (got[agree, j] == want[agree, j]).all()


def test_a_full_cache_is_refused():
    _, tc, _, pt, _, trt = _params("qwen2.5-14b")
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    generate(pt, tc, trt, prompt, 3, 6, device="cpu")  # 6 tokens fit
    with pytest.raises(ValueError, match="KV cache full"):
        generate(pt, tc, trt, prompt, 4, 6, device="cpu")


# ------------------------------------------------------------ training ----

def test_training_is_not_ported():
    """Training is ported (the name is kept from when it was not): the
    three entry points run and give finite results. Its values are held
    against the JAX package in tests/test_torch_train.py, and for the MoE
    / SSM architectures in tests/test_torch_ssm_moe.py."""
    _, tc, _, pt, _, trt = _params("phi3-mini-3.8b")
    x = torch.zeros((1, 4, tc.d_model), dtype=torch.bfloat16)
    pos = torch.zeros((1, 4), dtype=torch.int64)
    h, _ = tm.backbone(pt, tc, trt, x, pos, train=True)
    assert h.shape == x.shape and bool(torch.isfinite(h).all())
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    loss = tm.loss_fn(pt, tc, trt, {"tokens": tokens, "targets": tokens},
                      device="cpu")
    assert loss.shape == () and bool(torch.isfinite(loss))
    ce = tlm.chunked_ce_loss(pt, tc, trt, x, tokens)
    assert ce.shape == () and bool(torch.isfinite(ce))


def test_encoder_only_launch_is_refused_and_dgnn_serve_not_ported(capsys):
    """The launcher refuses an encoder-only LM; its DGNN mode (ported with
    the serve layer; the name is kept from when it was not) serves
    synthetic snapshots through the snapshot server on the CPU."""
    from repro_torch.launch import serve as launch

    with pytest.raises(SystemExit, match="encoder-only"):
        launch.main(["--lm", "hubert-xlarge", "--device", "cpu"])
    launch.main(["--dgnn", "gcrn-m2", "--device", "cpu", "--snapshots", "3"])
    out = capsys.readouterr().out
    assert "gcrn-m2 (v2) on uci, cpu: 3 snapshots" in out
    assert "ms/snapshot staging + launch" in out and "ms total" in out


def test_launch_serve_generates_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    launch.main(["--lm", "qwen2.5-14b", "--steps", "3", "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
