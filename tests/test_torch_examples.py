"""The port's examples (``examples/torch/``) compute the JAX examples'.

On the CPU. ``quickstart.run`` and ``serve_stream.run`` take the JAX
sessions' parameters (``params_from_jax``) and their outputs are held
against the JAX examples' steps, written out below, at the harness's
tolerance (3e-4, tests/harness.py): every served snapshot, the batched
and ragged launches, the multi-tenant serve. The JAX side runs under
``ops.set_force_ref(True)``: its stream engine does not build with the
installed jax (ROADMAP queue 3); its force-ref path does.
``lm_generate.run`` is held against the JAX example's tokens where the
JAX logits' top-2 margin exceeds ``tests/test_torch_lm.py``'s tolerance.
Then each ``examples/torch/*.py`` runs as a script with ``--device cpu``
at small flags and exits 0.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro import configs as jcfg
from repro import models as jm
from repro.configs.dgnn import (BC_ALPHA, DGNN_CONFIGS, GCRN_M2, STATIC_GCN,
                                TGN, UCI)
from repro.core import init_states_batched, run_plan_batched, stack_time
from repro.graph import (generate_temporal_graph, pad_event_block,
                         pad_snapshot, renumber_and_normalize,
                         slice_snapshots)
from repro.kernels import ops as jops
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.params import lm_params_from_jax, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ATOL = 3e-4
TOL = 2e-2
SNAPSHOTS, STREAMS = 4, 2


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def jax_oracle():
    jops.set_force_ref(True)
    yield
    jops.set_force_ref(False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(cfg, jparams):
    return params_from_jax(DGNNConfig(**dataclasses.asdict(cfg)),
                           _np(jparams))


def _session(cfg, p, tg, ft, seed):
    return japi.BoosterSession(cfg, p, n_global=tg.n_global_nodes,
                               feat_table=ft, rng=jax.random.PRNGKey(seed))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------- quickstart ----

def test_quickstart_matches_the_jax_example(capsys):
    """``examples/quickstart.py``'s steps in JAX, then the port's on the
    same parameters."""
    tg, ft = generate_temporal_graph(UCI)
    snaps = slice_snapshots(tg, time_splitter=1.0)[:24]
    gcrn = _session(GCRN_M2, japi.plan(GCRN_M2, level="v2"), tg, ft, 0)
    want_gcrn, _ = gcrn.serve(snaps)
    static = _session(STATIC_GCN, japi.plan(STATIC_GCN), tg, ft, 1)
    want_static, _ = static.serve(snaps[:8])
    rng = np.random.default_rng(7)
    G = tg.n_global_nodes
    blocks = []
    for _ in range(4):
        src = rng.integers(0, G, 12)
        dst = (src + rng.integers(1, G, 12)) % G
        ts = rng.uniform(0.0, 10.0, 12).astype(np.float32)
        blocks.append(pad_event_block(src, dst, ts, ft, n_pad=32, k_max=8))
    tgn = _session(TGN, japi.plan(TGN, level="v3"), tg, ft, 2)
    want_tgn = tgn.run(jax.tree.map(lambda *xs: np.stack(xs), *blocks))

    got = _load("quickstart").run(device="cpu", params={
        "gcrn": _port(GCRN_M2, gcrn.params),
        "static": _port(STATIC_GCN, static.params),
        "tgn": _port(TGN, tgn.params)})
    assert len(got["gcrn"]) == len(want_gcrn) == 24
    for g, w in zip(got["gcrn"], want_gcrn):
        _close(g, w)
    assert len(got["static"]) == len(want_static) == 8
    for g, w in zip(got["static"], want_static):
        _close(g, w)
    _close(got["tgn"], want_tgn)
    out = capsys.readouterr().out
    assert "served 24 snapshots" in out and "ms/snapshot" in out
    assert "static_gcn (temporal='static'): served 8 independent" in out
    assert f"tgn (temporal='event'): 4 event batches -> outputs " \
           f"{tuple(np.shape(want_tgn))}" in out


# -------------------------------------------------------- serve_stream ----

def _jax_serve_stream(snapshots, streams):
    """``examples/serve_stream.py``'s steps in JAX: (outputs by label, the
    params of each model)."""
    results, params = {}, {}
    for ds in (BC_ALPHA, UCI):
        tg, ft = generate_temporal_graph(ds)
        snaps = slice_snapshots(tg, 1.0)[:snapshots]
        for name, levels in (("evolvegcn", ("v1", "v3")),
                             ("gcrn-m2", ("v2", "v3"))):
            for lv in ("baseline",) + levels:
                s = _session(DGNN_CONFIGS[name],
                             japi.plan(DGNN_CONFIGS[name], level=lv), tg, ft,
                             0)
                params.setdefault(name, s.params)
                results[(ds.name, name, lv)], _ = s.serve(snaps)
    tg, ft = generate_temporal_graph(BC_ALPHA)
    snaps = slice_snapshots(tg, 1.0)[:snapshots]
    pads = [pad_snapshot(renumber_and_normalize(s), ft, 640, 4096, 64)
            for s in snaps]
    sT = stack_time(pads)
    B = streams
    sBT = jax.tree.map(lambda a: np.stack([a] * B, axis=0), sT)
    cfg = DGNN_CONFIGS["gcrn-m2"]
    for lv in ("v2", "v3"):
        p = japi.plan(cfg, level=lv, batch=B)
        s = _session(cfg, p, tg, ft, 0)
        states = init_states_batched(s.model, s.params, B, mode=lv)
        results[("batched", lv)] = run_plan_batched(s.model, s.params,
                                                    states, sBT, p)[1]
    s = _session(cfg, japi.plan(cfg, level="v3"), tg, ft, 0)
    lens = [max(snapshots // (i + 1), 2) for i in range(B)]
    _, results["ragged"] = s.run_batched([stack_time(pads[:t])
                                          for t in lens])
    n_per = max(snapshots // 2, 2)
    tenants = {f"client{i}": slice_snapshots(tg, 1.0)[i: i + n_per]
               for i in range(streams)}
    s = _session(cfg, japi.plan(cfg, level="v3", stream_chunk=4), tg, ft, 0)
    _, results["multi"], _ = s.serve_multi(tenants)
    return results, params


def test_serve_stream_matches_the_jax_example(capsys):
    want, jparams = _jax_serve_stream(SNAPSHOTS, STREAMS)
    got = _load("serve_stream").run(SNAPSHOTS, STREAMS, device="cpu", params={
        name: _port(DGNN_CONFIGS[name], p) for name, p in jparams.items()})
    assert set(got) == set(want)
    for key in want:
        if key == "multi":
            assert set(got[key]) == set(want[key])
            pairs = [(g, w) for sid in want[key]
                     for g, w in zip(got[key][sid], want[key][sid])]
            assert len(pairs) == sum(len(v) for v in want[key].values())
        elif key[0] == "batched":
            pairs = [(got[key], want[key])]
        else:
            assert len(got[key]) == len(want[key])
            pairs = list(zip(got[key], want[key]))
        for g, w in pairs:
            _close(g, w)
    out = capsys.readouterr().out
    assert out.count("ms/snapshot (host prep") == 12
    assert f"batched streams [v3]: {STREAMS} x {SNAPSHOTS} snapshots" in out
    assert "ragged batch [v3]: lengths [4, 2] in one launch -> " \
           "per-stream outputs [4, 2]" in out
    assert f"multi-tenant v3: {STREAMS} clients, 4 snapshots" in out


# --------------------------------------------------------- lm_generate ----

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2.5-14b"])
def test_lm_generate_matches_the_jax_example(arch, capsys):
    """The JAX example's tokens (its reduced config, PRNGKey(0) params,
    prompt [1, 2, 3, 4]), where the JAX logits' top-2 margin exceeds TOL;
    the port's logits at every step within TOL of JAX's (unrolled loop,
    as tests/test_torch_ssm_moe.py says why)."""
    cfg = jcfg.reduce_for_smoke(jcfg.ARCHS[arch])
    rt = jm.RuntimeConfig(tp=1, moe_impl="dense", attn_chunk=128,
                          scan_layers=False)
    params, _ = jm.init_params(cfg, rt, jax.random.PRNGKey(0))
    prompt = jnp.asarray([[1, 2, 3, 4]] * 2, jnp.int32)
    from repro.serve import generate as jgenerate

    want = np.asarray(jgenerate(params, cfg, rt, prompt, steps=6, skv=128))
    tc = tcfg.reduce_for_smoke(tcfg.ARCHS[arch])
    trt = tm.RuntimeConfig(tp=1, moe_impl="dense", attn_chunk=128)
    pt = lm_params_from_jax(tc, trt, _np(params))
    got = _load("lm_generate").run(arch, steps=6, batch=2, device="cpu",
                                   params=pt).numpy()
    assert got.shape == want.shape == (2, 6) and got.dtype == np.int32
    # the margin of each step's choice, on JAX's own sequence
    seq = np.concatenate([np.asarray(prompt), want], axis=1)
    caches = jm.init_caches(cfg, rt, 2, 128)
    agree = np.ones(2, bool)
    for i in range(seq.shape[1] - 1):
        logits, caches = jm.decode_step(params, cfg, rt,
                                        jnp.asarray(seq[:, i:i + 1]), caches)
        j = i - 3
        if j < 0:
            continue
        lg = np.asarray(logits)[:, -1, :cfg.vocab_size]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        agree &= (top2[:, 1] - top2[:, 0]) > TOL * np.abs(lg).max()
        assert (got[agree, j] == want[agree, j]).all()
    out = capsys.readouterr().out
    assert out.startswith(f"{arch} (reduced ")
    assert "  lane 0: [" in out and "  lane 1: [" in out


# ------------------------------------------------------------- scripts ----

SCRIPTS = {
    "train_evolvegcn": ["--steps", "3"],
    "quickstart": [],
    "serve_stream": ["--snapshots", "4", "--streams", "2"],
    "lm_generate": ["--steps", "4"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_each_example_runs_as_a_script_on_the_cpu(name, tmp_path):
    args = list(SCRIPTS[name])
    if name == "train_evolvegcn":
        args += ["--ckpt", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
         *args, "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip()


def test_every_jax_example_has_a_port():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert jax_examples == set(SCRIPTS)
    assert {p.stem for p in (ROOT / "examples" / "torch").glob("*.py")} \
        == set(SCRIPTS)
