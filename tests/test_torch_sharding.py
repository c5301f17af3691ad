"""The port's device sharding (``launch/mesh.py``, ``distributed/api.py``,
the sharded DGNN launch, elastic restore, tokens under a mesh) against the
JAX package's, on the CPU.

* ``DEFAULT_RULES`` equal JAX's; ``resolve_spec`` equals JAX's
  ``PartitionSpec`` entries over a table of shapes x logical names x
  meshes (1, 1), (2, 4) and (2, 16, 16) (duck-typed meshes on both sides:
  the two read only the axis names and sizes), and with no mesh;
  ``placements`` shard each tensor dim over the mesh axes its entry names.
* The sharded DGNN launch (the counterpart of ``tests/test_api.py``'s
  ``test_device_spec_sharded_launch_identical``): every family at B 4 with
  ``DeviceSpec(2)`` and ``DeviceSpec(4)`` on CPU slices (the card count
  stubbed) bit for bit the unsharded launch, kernels' plain versions and
  force-ref alike, and within 1e-5 of the JAX package's sharded launch (a
  subprocess with 8 forced host devices under ``set_force_ref(True)``: its
  interpret-mode engine does not build under jax 0.9); the refusals
  (B not divisible, keyword stream args, too few cards).
* A checkpoint the JAX package wrote, restored by the port onto a (1, 2)
  mesh on 2 ``gloo`` ranks: each rank's local shard is its slice bit for
  bit; the tokens under a (2, 1) mesh are JAX's, each rank its batch slice.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import harness
import torch_dist_ranks as R
from repro import api as japi
from repro.checkpoint import CheckpointManager as JManager
from repro.configs import ARCHS as JARCHS, reduce_for_smoke as jreduce
from repro.data import synthetic_lm_batches as jtokens
from repro.distributed import api as jdist
from repro_torch import api as tapi
from repro_torch.configs.dgnn import DGNNConfig
from repro_torch.distributed import api as tdist
from repro_torch.kernels import ops
from repro_torch.graph.padding import PaddedSnapshot
from repro_torch.launch import mesh as tmesh
from repro_torch.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4

# ---------------------------------------------------------------- rules ----

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 4)),
          (("pod", "data", "model"), (2, 16, 16))]
SHAPES = [(8, 64), (64, 128), (6, 10), (32, 1), (512, 48)]
NAMES = [n for n, _ in jdist.DEFAULT_RULES] + [None, "unknown"]


def _jax_mesh(names, shape):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(names, shape):
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def test_default_rules_equal_jax():
    import repro.distributed as jpkg
    import repro_torch.distributed as tpkg

    assert tdist.DEFAULT_RULES == jdist.DEFAULT_RULES
    assert tpkg.__all__ == jpkg.__all__


@pytest.mark.parametrize("mesh", MESHES, ids=["1x1", "2x4", "2x16x16"])
def test_resolve_spec_equals_jax(mesh):
    names, shape = mesh
    jm, tm = _jax_mesh(names, shape), _port_mesh(names, shape)
    seen = set()
    for shp in SHAPES:
        for a in NAMES:
            for b in NAMES:
                want = tuple(jdist.resolve_spec(shp, (a, b), jm))
                got = tdist.resolve_spec(shp, (a, b), tm)
                assert got == want, (shp, a, b)
                seen.add(got)
                # each mesh axis shards the dim whose entry names it
                for axis, pl in zip(names, tdist.placements(got, tm)):
                    dims = [d for d, e in enumerate(got)
                            if e == axis or (isinstance(e, tuple)
                                             and axis in e)]
                    assert pl == (Shard(dims[0]) if dims else Replicate())
    # the table exercises sharded, tuple and fallback entries alike
    if shape != (1, 1):
        assert any(any(e is not None for e in s) for s in seen)
    assert (None, None) in seen


def test_resolve_spec_no_mesh_passthrough():
    """tests/test_sharding_roofline.py's case, and every rule the same."""
    assert tdist.resolve_spec((64, 128), ("batch", "ffn"), mesh=None) == \
        (("pod", "data"), "model")
    for a in NAMES:
        assert tdist.resolve_spec((8,), (a,)) == \
            tuple(jdist.resolve_spec((8,), (a,)))


def test_sharding_ctx_and_shard_without_a_mesh():
    x = torch.ones(4, 6)
    assert tdist.current_mesh() is None and tdist.shard(x, "batch") is x
    m = _port_mesh(("data", "model"), (2, 4))
    with tdist.sharding_ctx(m, {"batch": "data"}):
        assert tdist.current_mesh() is m
        assert tdist.resolve_spec((4, 6), ("batch", "ffn")) == ("data", None)
    assert tdist.current_mesh() is None
    with pytest.raises(ValueError, match="needs a mesh"):
        tdist.named_sharding((4,), ("batch",))


def test_tree_shardings_and_axes():
    m = _port_mesh(("data", "model"), (2, 4))
    shapes = {"w": torch.zeros(8, 16), "b": [torch.zeros(16)]}
    axes = {"w": tdist.Axes("embed_fsdp", "ffn"), "b": [tdist.Axes("ffn")]}
    sh = tdist.tree_shardings(shapes, axes, m)
    assert sh["w"].spec == ("data", "model") and sh["b"][0].spec == ("model",)
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert tdist.Axes("a", None) == tdist.Axes("a", None)
    assert repr(tdist.Axes("a")) == repr(jdist.Axes("a"))


# ------------------------------------------------------------- meshes ----

def test_meshes_refuse_what_the_host_lacks(monkeypatch):
    spec = tmesh.DeviceSpec(n_devices=3)
    assert tmesh.make_stream_mesh(spec, "cpu") == [torch.device("cpu")] * 3
    assert tapi.DeviceSpec is tmesh.DeviceSpec
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="wants 3 devices, have 1"):
        tmesh.make_stream_mesh(spec, "cuda")


def test_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()
    assert not torch.distributed.is_initialized()


# --------------------------------------------------- sharded DGNN launch ----

JAX_SCRIPT = """
import sys
import numpy as np, jax
import harness
from repro import api
from repro.kernels import ops
ops.set_force_ref(True)
out = {}
for family in sorted(ops.stream_families()):
    args, _, _ = harness.stream_kernel_case(family, seed=3, B=4)
    for n in (2, 4):
        p = api.plan(family=family, level="v3", batch=4, tn=32,
                     device=api.DeviceSpec(n_devices=n))
        got = jax.jit(lambda *a: api.run_arrays(p, *a))(*args)
        for i, leaf in enumerate(jax.tree.leaves(got)):
            out[f"{family}_{n}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("shard") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=R.TIMEOUT_S)
    assert r.returncode == 0, r.stderr
    return dict(np.load(path))


def _leaves(out) -> list:
    return [t for o in out
            for t in (o if isinstance(o, (list, tuple)) else [o])]


@pytest.mark.parametrize("family", ops.stream_families())
def test_sharded_launch_is_the_unsharded_one(family, jax_sharded,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args, _, _ = harness.stream_kernel_case(family, seed=3, B=B)
    base = _leaves(ops.stream_steps_batched(family, *args, tn=32,
                                            device="cpu"))
    ref = _leaves(ops.stream_steps_batched(family, *args, tn=32,
                                           device="cpu", force_ref=True))
    for n in (2, 4):
        p = tapi.plan(family=family, level="v3", batch=B, tn=32,
                      device=tapi.DeviceSpec(n_devices=n))
        got = _leaves(tapi.run_arrays(p, *args, device="cpu"))
        assert len(got) == len(base)
        for g, w in zip(got, base):
            assert torch.equal(g, w), (family, n)
        got_ref = _leaves(tapi.run_arrays(p, *args, device="cpu",
                                          force_ref=True))
        for i, (g, w) in enumerate(zip(got_ref, ref)):
            assert torch.equal(g, w), (family, n, "force_ref")
            np.testing.assert_allclose(g.numpy(),
                                       jax_sharded[f"{family}_{n}_{i}"],
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["gcrn-m2", "evolvegcn",
                                  "stacked-gcn-gru", "static-gcn"])
def test_sharded_session_equals_the_unsharded_one(name, monkeypatch):
    """BoosterSession.run_batched with a sharded plan, ragged over T, bit
    for bit the unsharded session (the harness's random streams)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    case = harness.make_case(name, T=5, B=B)
    cfg = DGNNConfig(**dataclasses.asdict(case.cfg))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, case.params))
    streams = [PaddedSnapshot(**{f.name: np.asarray(getattr(s, f.name))[:t]
                                 for f in dataclasses.fields(PaddedSnapshot)})
               for s, t in zip(case.stacked, (5, 3, 4, 2))]
    runs = [tapi.BoosterSession(
        cfg, tapi.plan(cfg, level="v3", batch=B,
                       device=tapi.DeviceSpec(n_devices=n)),
        n_global=case.n_global, params=params,
        device="cpu").run_batched(streams) for n in (2, 1)]
    (st_s, outs_s), (st_p, outs_p) = runs
    for a, b in zip(outs_s, outs_p):
        assert torch.equal(a, b)
    for k in st_p:
        for a, b in zip(_leaves([st_s[k]]), _leaves([st_p[k]])):
            assert torch.equal(a, b)


def test_sharded_launch_refusals(monkeypatch):
    args, _, _ = harness.stream_kernel_case("gcrn", seed=3, B=B)
    with pytest.raises(ValueError, match="not divisible by DeviceSpec"):
        ops.stream_steps_batched("gcrn", *args, device="cpu",
                                 device_spec=tapi.DeviceSpec(n_devices=3))
    with pytest.raises(ValueError, match="keyword stream args"):
        ops.stream_steps_batched("gcrn", *args[:-1], b=args[-1],
                                 device="cpu",
                                 device_spec=tapi.DeviceSpec(n_devices=2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="this host has 1"):
        tapi.plan(family="gcrn", batch=B, device=tapi.DeviceSpec(2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="not divisible by n_devices"):
        tapi.plan(family="gcrn", batch=3, device=tapi.DeviceSpec(2))


# ------------------------------------------------ restore and tokens ----

def test_restore_onto_a_mesh_and_tokens_under_one(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(6, 8)).astype(np.float32),
            "b": rng.normal(size=(10,)).astype(np.float32),
            "c": rng.normal(size=(4, 3)).astype(np.float32)}
    JManager(str(tmp_path / "ck")).save(3, jax.tree.map(jax.numpy.asarray,
                                                        tree), blocking=True)
    inp = {f"ck_{k}": v for k, v in tree.items()}
    inp.update(ck_dir=str(tmp_path / "ck"), ck_step=3)
    ranks = R.spawn(R.restore_and_tokens, 2, tmp_path, inp)
    want_tok = next(jtokens(jreduce(JARCHS["qwen2.5-14b"]), 4, 16, seed=5))
    for rank, out in enumerate(ranks):
        # (data 1, model 2): "ffn" and "vocab" over model, "batch" kept
        np.testing.assert_array_equal(out["ck_a"].numpy(),
                                      tree["a"][:, rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(out["ck_b"].numpy(),
                                      tree["b"][rank * 5:(rank + 1) * 5])
        np.testing.assert_array_equal(out["ck_c"].numpy(), tree["c"])
        assert out["ck_a_placements"] == "(Replicate(), Shard(dim=1))"
        # (data 2, model 1): each rank its two sequences
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(
                out[f"tok_{k}"].numpy(),
                np.asarray(want_tok[k])[rank * 2:(rank + 1) * 2])
