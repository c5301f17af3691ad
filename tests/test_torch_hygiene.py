"""Hygiene of the port: no JAX inside it, the card by default, no fallback.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` (its own ``repro_torch`` is fine).
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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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


@pytest.mark.parametrize("name", ["tgn_engine", "static_engine"])
def test_new_engine_wrappers_need_the_card_for_cuda_tensors(no_cuda, name):
    """The CPU path of the tgn / static wrappers is their plain version,
    only for CPU tensors; the kernel itself is only reachable with a card."""
    args, _, _ = harness.stream_kernel_case(
        "tgn" if name == "tgn_engine" else "static_gcn", seed=1, B=2)
    family = "tgn" if name == "tgn_engine" else "static_gcn"
    packed = ops.pack(family, *ops.to_device(tuple(args), "cpu"))
    engine.reset_launches()
    getattr(engine, name)(*packed)  # plain version: counts nothing
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


@pytest.mark.parametrize("name", ["gcrn_step", "stacked_step", "ell_spmm"])
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
                             z(3 * h))}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.prepare(name, *args)
    assert all(v == 0 for v in engine.LAUNCHES.values())
