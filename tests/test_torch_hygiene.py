"""Hygiene of the port: no JAX inside it, the card by default, no fallback.

* No module of ``src/repro_torch``, no example of ``examples/torch`` and
  not ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro`` (its
  own ``repro_torch`` is fine).
* Entry points asked for the default device on a host without CUDA raise
  instead of running on the CPU.
* The kernel wrappers run the plain version only for CPU tensors: where
  the kernel cannot be built or launched they raise.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import harness
from repro_torch import api
from repro_torch.configs.dgnn import GCRN_M2, STATIC_GCN, TGN
from repro_torch.kernels import engine, ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device runs")


def test_entry_points_default_to_cuda_and_raise(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.BoosterSession(GCRN_M2, api.plan(GCRN_M2, level="v3"))
    args, _, _ = harness.stream_kernel_case("gcrn", seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.stream_steps("gcrn", *args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.stream_steps_batched("gcrn", *[a[None] for a in args[:8]],
                                 *args[8:])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_arrays(api.plan(family="gcrn"), *args)


def test_kernel_wrappers_raise_instead_of_falling_back(no_cuda):
    for name in engine.KERNELS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine._library(name)
    meta = torch.zeros((1, 1, 8, 2), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        engine.gcrn_engine(*([meta] * 11))
    with pytest.raises(ValueError, match="not supported"):
        engine.evolve_engine(*([meta] * 10))
    with pytest.raises(ValueError, match="not supported"):
        engine.tgn_engine(*([meta] * 12))
    with pytest.raises(ValueError, match="not supported"):
        engine.static_engine(*([meta] * 6))
    for name, n_args in (("gcrn_engine_paged", 11),
                         ("evolve_engine_paged", 10),
                         ("stacked_engine_paged", 12),
                         ("tgn_engine_paged", 12)):
        with pytest.raises(ValueError, match="not supported"):
            getattr(engine, name)(*([meta] * n_args), td=8, depth=2)
    meta2 = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        engine.fused_gru(*([meta2] * 5), tb=8)
    with pytest.raises(ValueError, match="not supported"):
        engine.fused_lstm(*([meta2] * 6), tb=8)
    assert all(v == 0 for v in engine.LAUNCHES.values())


@pytest.mark.parametrize("family", ["tgn", "static_gcn"])
def test_event_and_static_entry_points_default_to_cuda_and_raise(no_cuda,
                                                                  family):
    cfg = {"tgn": TGN, "static_gcn": STATIC_GCN}[family]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.BoosterSession(cfg, api.plan(cfg, level="v3"))
    args, _, _ = harness.stream_kernel_case(family, seed=0, B=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.stream_steps_batched(family, *args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_arrays(api.plan(family=family, batch=2), *args)


def _cpu_call(name):
    """One call of the kernel wrapper ``name`` on small CPU tensors."""
    if name in ("fused_gru", "fused_lstm"):
        z = lambda *s: torch.zeros(s)
        g = 3 if name == "fused_gru" else 4
        c = (z(16, 8),) if name == "fused_lstm" else ()
        return getattr(engine, name)(z(16, 4), z(16, 8), *c, z(4, g * 8),
                                     z(8, g * 8), z(g * 8), tb=8)
    family = name.removesuffix("_paged").removesuffix("_engine")
    family = "static_gcn" if family == "static" else family
    args, _, _ = harness.stream_kernel_case(family, seed=1, B=2)
    paged = name.endswith("_paged")
    packed = ops.pack(family, *ops.to_device(tuple(args), "cpu"),
                      residency="hbm_paged" if paged else "vmem")
    ring = dict(td=8, depth=2) if paged else {}
    return getattr(engine, name)(*packed, **ring)


@pytest.mark.parametrize("name", [
    "tgn_engine", "static_engine", "gcrn_engine_paged", "evolve_engine_paged",
    "stacked_engine_paged", "tgn_engine_paged", "fused_gru", "fused_lstm"])
def test_new_engine_wrappers_need_the_card_for_cuda_tensors(no_cuda, name):
    """The CPU path of the tgn / static, paged and RNN-cell wrappers is
    their plain version, only for CPU tensors; the kernel itself is only
    reachable with a card."""
    engine.reset_launches()
    _cpu_call(name)  # plain version: counts nothing
    assert engine.LAUNCHES[name] == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine._library(name)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    args, oracle, _ = harness.stream_kernel_case("gcrn", seed=2)
    engine.reset_launches()
    outs, hT, cT = ops.stream_steps("gcrn", *args, tn=32, device="cpu")
    want = oracle(*args)
    np.testing.assert_allclose(outs.numpy(), np.asarray(want[0]), atol=3e-4)
    assert engine.LAUNCHES == {name: 0 for name in engine.KERNELS}


@pytest.mark.parametrize("name", ["gcrn_step", "stacked_step", "ell_spmm",
                                  "fused_gru", "fused_lstm"])
def test_prepare_raises_without_a_card(no_cuda, name):
    """A prepared launch exists only on the card: ``engine.prepare`` checks
    the tensors, then needs the kernel library, and raises without it."""
    z = lambda *s: torch.zeros(s)
    i = lambda *s: torch.zeros(s, dtype=torch.int32)
    n, k, d, h = 8, 2, 4, 8
    args = {"ell_spmm": (i(n, k), z(n, k), i(n, k), z(n, d)),
            "gcrn_step": (i(n, k), z(n, k), i(n, k), z(n, d), z(n, h),
                          z(n, h), z(d, 4 * h), z(h, 4 * h), z(4 * h)),
            "stacked_step": (i(n, k), z(n, k), i(n, k), z(n, d), z(n, h),
                             z(d, h), z(h), z(h, 3 * h), z(h, 3 * h),
                             z(3 * h)),
            "fused_gru": (z(n, d), z(n, h), z(d, 3 * h), z(h, 3 * h),
                          z(3 * h)),
            "fused_lstm": (z(n, d), z(n, h), z(n, h), z(d, 4 * h),
                           z(h, 4 * h), z(4 * h))}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.prepare(name, *args,
                       **({"tb": n} if name.startswith("fused") else {}))
    assert all(v == 0 for v in engine.LAUNCHES.values())


@pytest.mark.parametrize("name", ["flash_attention", "flash_fwd"])
def test_flash_wrappers_need_the_card_for_cuda_tensors(no_cuda, name):
    """The flash wrappers run their plain version for CPU tensors, counting
    no launch; the kernel is only reachable with a card, and a tensor on
    any other device is refused."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = torch.zeros((4, 16, 16)), torch.zeros((2, 16, 16)), \
        torch.zeros((2, 16, 16))
    engine.reset_launches()
    if name == "flash_fwd":
        fa.flash_fwd(q, k, v, True, 16, 16, 2)
    else:
        fa.flash_attention(q, k, v, causal=True, bq=16, bk=16, group=2)
    assert all(v == 0 for v in engine.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine._library(name)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="not supported"):
        getattr(fa, name)(*meta, causal=True, bq=16, bk=16, group=2)


def test_lm_entry_points_default_to_cuda_and_raise(no_cuda):
    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.models import RuntimeConfig, init_caches, init_params
    from repro_torch.models import prefill_step
    from repro_torch.serve import generate

    cfg, rt = reduce_for_smoke(ARCHS["qwen2.5-14b"]), RuntimeConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, rt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(cfg, rt, 1, 8)
    params = init_params(cfg, rt, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill_step(params, cfg, rt, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(params, cfg, rt, tokens, 2, 8)
    assert all(v == 0 for v in engine.LAUNCHES.values())


def _lm_helper_call(name, **kw):
    """One call of the LM helper ``name`` at a reduced Qwen2.5 shape; ``kw``
    carries the device."""
    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.nn import attention, layers, mlp

    cfg = reduce_for_smoke(ARCHS["qwen2.5-14b"])
    gen = torch.Generator().manual_seed(0)
    d, v = cfg.d_model, cfg.padded_vocab()
    return {
        "normal_init": lambda: layers.normal_init(gen, (d, d), 0.02, **kw),
        "init_embedding": lambda: layers.init_embedding(gen, v, d, **kw),
        "init_lm_head": lambda: layers.init_lm_head(gen, d, v, **kw),
        "init_rms_norm": lambda: layers.init_rms_norm(d, **kw),
        "rope_freqs": lambda: layers.rope_freqs(16, 1e4, **kw),
        "vocab_mask": lambda: layers.vocab_mask(v, cfg.vocab_size, **kw),
        "init_mlp": lambda: mlp.init_mlp(gen, d, cfg.d_ff, 2, **kw),
        "init_attention": lambda: attention.init_attention(gen, cfg, 1, **kw),
        "init_decode_cache": lambda: attention.init_decode_cache(
            cfg, 1, 8, 1, **kw),
    }[name]()


@pytest.mark.parametrize("name", [
    "normal_init", "init_embedding", "init_lm_head", "init_rms_norm",
    "rope_freqs", "vocab_mask", "init_mlp", "init_attention",
    "init_decode_cache"])
def test_lm_helpers_default_to_cuda_and_raise(no_cuda, name):
    """The LM layers' public constructors build on the card unless the
    caller passes device="cpu": without a card the default raises, and
    "cpu" builds CPU tensors."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _lm_helper_call(name)
    out = _lm_helper_call(name, device="cpu")
    leaves = list(out.values()) if isinstance(out, dict) else [out]
    assert leaves and all(t.device.type == "cpu" for t in leaves)


# ------------------------------------ no kernel drops a gradient ----
# A kernel writes its outputs through a raw pointer, so on the card its
# result has no grad_fn: every wrapper (and ``engine.prepare``) refuses an
# input that requires grad where autograd is on, on the CPU too, as the
# JAX package's Pallas kernels refuse ``jax.grad``. The plain (force-ref)
# paths and ``flash_mha`` stay differentiable.

def _grad_case(name):
    """(the wrapper ``name``, its arguments, its keyword arguments, a
    differentiable call of the same function) on small CPU tensors, one
    float input requiring grad."""
    from repro_torch.kernels import flash_attention as fa

    z = lambda *s: torch.zeros(s, requires_grad=True)
    i = lambda *s: torch.zeros(s, dtype=torch.int32)
    n, k, d, h = 8, 2, 4, 8
    if name in ("gcrn_step", "stacked_step", "ell_spmm"):
        lanes = (i(n, k), torch.ones(n, k), i(n, k))
        args = {"ell_spmm": (*lanes, z(n, d)),
                "gcrn_step": (*lanes, z(n, d), z(n, h), z(n, h),
                              z(d, 4 * h), z(h, 4 * h), z(4 * h)),
                "stacked_step": (*lanes, z(n, d), z(n, h), z(d, h), z(h),
                                 z(h, 3 * h), z(h, 3 * h), z(3 * h))}[name]
        ref = {"ell_spmm": ops.ell_spmm, "gcrn_step": ops.dgnn_fused_step,
               "stacked_step": ops.stacked_fused_step}[name]
        return (getattr(engine, name), args, {},
                lambda: ref(*args, force_ref=True))
    if name == "edge_terms":
        args = (i(2, n, k), torch.ones(2, n, k), z(2, 6, d),
                torch.full((2,), n, dtype=torch.int32), [z(d, d), z(d, h)],
                h)
        return (engine.edge_terms, args, {},
                lambda: engine.edge_terms_plain(*args))
    if name in ("fused_gru", "fused_lstm"):
        g = 3 if name == "fused_gru" else 4
        c = (z(16, 8),) if name == "fused_lstm" else ()
        args = (z(16, 4), z(16, 8), *c, z(4, g * 8), z(8, g * 8), z(g * 8))
        return (getattr(engine, name), args, {"tb": 8},
                lambda: getattr(ops, name)(*args, tb=8, force_ref=True,
                                           device="cpu"))
    if name in ("flash_attention", "flash_fwd"):
        args = (z(4, 32, 16), z(2, 32, 16), z(2, 32, 16))
        kw = dict(causal=True, bq=32, bk=32, group=2)
        return getattr(fa, name), args, kw, lambda: fa.flash_mha(*args, **kw)
    if name.startswith("flash_bwd"):
        lse = torch.zeros((4, 32))
        args = (z(4, 32, 16), z(2, 32, 16), z(2, 32, 16), z(4, 32, 16), lse,
                lse, True, 32, 32, 2)
        return (getattr(fa, name), args, {},
                lambda: getattr(fa, f"{name}_plain")(*args))
    family = name.removesuffix("_paged").removesuffix("_engine")
    family = "static_gcn" if family == "static" else family
    args, _, _ = harness.stream_kernel_case(family, seed=1, B=2)
    args = ops.to_device(tuple(args), "cpu")
    weight = next(a for a in reversed(args)
                  if torch.is_tensor(a) and a.is_floating_point())
    weight.requires_grad_(True)
    paged = name.endswith("_paged")
    plan = (dict(state_residency="hbm_paged", td=8, buffer_depth=2)
            if paged else {})
    packed = ops.pack(family, *args,
                      residency="hbm_paged" if paged else "vmem")
    return (getattr(engine, name), packed,
            dict(td=8, depth=2) if paged else {},
            lambda: ops.stream_steps_batched(family, *args, force_ref=True,
                                             device="cpu", **plan))


@pytest.mark.parametrize("name", [
    *engine.KERNELS, *(f"prepare:{n}" for n in (
        "gcrn_step", "stacked_step", "ell_spmm", "fused_gru", "fused_lstm"))])
def test_kernel_wrappers_refuse_an_input_that_requires_grad(name):
    prepared = name.startswith("prepare:")
    name = name.removeprefix("prepare:")
    wrapper, args, kw, _ = _grad_case(name)
    engine.reset_launches()
    with pytest.raises(NotImplementedError, match="no gradient"):
        if prepared:
            engine.prepare(name, *args, **kw)
        else:
            wrapper(*args, **kw)
    assert not any(engine.LAUNCHES.values())


@pytest.mark.parametrize("name", engine.KERNELS)
def test_kernel_wrappers_run_under_no_grad_and_the_plain_path_differentiates(
        name):
    wrapper, args, kw, plain = _grad_case(name)
    with torch.no_grad():
        wrapper(*args, **kw)
    out = plain()
    first = out[0] if isinstance(out, (tuple, list)) else out
    assert first.requires_grad and first.grad_fn is not None


@pytest.mark.parametrize("entry", ["loss_fn", "train", "launch.train",
                                   "synthetic_lm_batches"])
def test_training_entry_points_default_to_cuda_and_raise(no_cuda, entry):
    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.launch import train as launch
    from repro_torch.models import RuntimeConfig, init_params, loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainLoopConfig, train

    cfg, rt = reduce_for_smoke(ARCHS["phi3-mini-3.8b"]), RuntimeConfig()
    params = init_params(cfg, rt, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    batch = {"tokens": tokens, "targets": tokens}
    call = {"loss_fn": lambda: loss_fn(params, cfg, rt, batch),
            "train": lambda: train(lambda p, b: loss_fn(p, cfg, rt, b,
                                                        device="cpu"),
                                   params, [batch], AdamWConfig(),
                                   TrainLoopConfig(total_steps=1)),
            "launch.train": lambda: launch.main(["--arch", "phi3-mini-3.8b",
                                                 "--steps", "1"]),
            "synthetic_lm_batches": lambda: next(synthetic_lm_batches(
                cfg, 1, 4))}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# ------------------------------------------------------ the serve layer ----

@pytest.mark.parametrize("entry", ["SnapshotServer", "BoosterSession.serve",
                                   "launch.serve --dgnn"])
def test_serve_entry_points_default_to_cuda_and_raise(no_cuda, entry):
    """The snapshot server lives on its session's device, the card unless
    the caller asks for the CPU; without a card the default raises before
    any producer thread starts."""
    import contextlib
    import threading

    from repro_torch.graph.coo import COOSnapshot
    from repro_torch.launch import serve as launch
    from repro_torch.serve import SnapshotServer

    ft = np.zeros((16, GCRN_M2.in_dim), np.float32)
    snap = COOSnapshot(src=np.asarray([0, 1]), dst=np.asarray([1, 2]),
                       edge_feat=np.zeros((2, GCRN_M2.edge_dim), np.float32),
                       t_index=0)
    call = {
        "SnapshotServer": lambda: SnapshotServer(GCRN_M2, ft, n_global=16),
        "BoosterSession.serve": lambda: api.BoosterSession(
            GCRN_M2, api.plan(GCRN_M2, level="v3"), n_global=16,
            feat_table=ft, gen=torch.Generator().manual_seed(0)).serve([snap]),
        "launch.serve --dgnn": lambda: launch.main(
            ["--dgnn", "gcrn-m2", "--snapshots", "2"]),
    }[entry]
    expect = (pytest.warns(DeprecationWarning, match="keyword surface")
              if entry == "SnapshotServer" else contextlib.nullcontext())
    with expect, pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dgnn-serve")]
    # on the CPU, when asked for
    sess = api.BoosterSession(GCRN_M2, api.plan(GCRN_M2, level="v3"),
                              n_global=16, feat_table=ft,
                              gen=torch.Generator().manual_seed(0),
                              device="cpu")
    outs, stats = sess.serve([snap])
    assert len(outs) == 1 and stats.launches == 1


SERVE_FILES = sorted((ROOT / "src" / "repro_torch" / "serve").rglob("*.py"))


def test_port_serve_layer_is_lint_clean():
    """``python -m repro.analysis``'s lint rules over the port's serve
    layer: zero findings and zero suppressions. The supervised runner, the
    calibration fallback and the consumer loops catch
    ``faults.SUPERVISED`` (the analyzer's broad-except allowlist names the
    JAX engine only), and the producer threads hand their errors on
    through a context manager, not a broad except. Its public surface,
    ``repro_torch.serve.__all__``, is the JAX package's."""
    import repro.serve
    import repro_torch.serve
    from repro.analysis import core, lint

    assert repro_torch.serve.__all__ == repro.serve.__all__

    files = [p.relative_to(ROOT).as_posix() for p in SERVE_FILES]
    assert "src/repro_torch/serve/engine.py" in files
    report = core.Report(rules_run=tuple(sorted(lint.RULES)))
    findings = core.apply_suppressions(
        lint.run_lint(ROOT, files=files, rules=frozenset(lint.RULES)), ROOT,
        report)
    assert findings == [] and report.suppressed == 0
    for path in SERVE_FILES:
        assert "booster: ignore" not in path.read_text(), path
