"""The port's DGNN trainer (``examples/torch/train_evolvegcn.py``) computes
the JAX example's (``examples/train_evolvegcn.py``).

On the CPU at the example's full width (BC-Alpha: n_pad 640, e_pad 4096,
k_max 64, a window of 6 snapshots, 256 pairs), the JAX example loaded
with ``importlib``, its closure loss (``main``'s ``loss_fn``) written out
below, the JAX parameters carried across by ``params.params_from_jax``:

* ``build_batches``: the windows, pairs, renumber tables and masks equal
  the JAX example's bit for bit (the same numpy draws in the same order);
* the first batch's loss within ``TOL_LOSS`` = 1e-5 relative (measured
  3.4e-7) and each of the 12 gradient leaves within ``TOL_GRAD`` = 1e-5
  of its max |value| (measured at most 1.0e-6);
* 4 AdamW steps of ``repro_torch.train.train`` against
  ``repro.train.train`` (the example's optimizer and loop): each step's
  loss within 1e-5 relative (measured 5.2e-7), then the parameters and
  both moments from each loop's final checkpoint within ``TOL_STATE`` =
  1e-4 of each leaf's max |value| (measured: parameters 3.7e-5, first
  moments 8.9e-7, second 1.5e-6; AdamW's normalised update turns the
  gradients' fp32 rounding into a near-zero bias leaf's relative error);
* resume: a port run saves at steps 2 and 4; a second run resumes from
  step 4 to 6, and the JAX loop resumes from the same checkpoint (the
  port writes the JAX format), its two losses within 1e-5 relative;
* ``main(["--steps", "3", "--device", "cpu", "--ckpt", tmp])`` prints the
  JAX example's three lines.
"""
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as jplan
from repro.configs.dgnn import BC_ALPHA as J_BC_ALPHA
from repro.configs.dgnn import EVOLVEGCN as J_EVOLVEGCN
from repro.core import build_model as jbuild_model
from repro.core import run_plan as jrun_plan
from repro.graph import generate_temporal_graph as jgenerate
from repro.graph import slice_snapshots as jslice
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import TrainLoopConfig as JTrainLoopConfig
from repro.train import train as jtrain
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.dgnn import EVOLVEGCN
from repro_torch.optim import init_opt_state, tree_leaves
from repro_torch.params import params_from_jax
from repro_torch.train import TrainLoopConfig, train

ROOT = Path(__file__).resolve().parents[1]
TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_STATE = 1e-4
STEPS = 4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jex = _load("examples/train_evolvegcn.py", "jax_train_evolvegcn")
tex = _load("examples/torch/train_evolvegcn.py", "torch_train_evolvegcn")


@pytest.fixture(scope="module")
def world():
    """The JAX example's data, model, v1 plan and seed-0 parameters (numpy:
    the JAX loop donates its parameters, so each use takes ``_jax``'s
    fresh copy)."""
    tg, ft = jgenerate(J_BC_ALPHA)
    snaps = jslice(tg, 1.0)
    model = jbuild_model(J_EVOLVEGCN, n_global=tg.n_global_nodes)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    return tg, ft, snaps, model, params, jplan(J_EVOLVEGCN, level="v1")


def _jax(params_np):
    return jax.tree.map(jnp.array, params_np)


def _jax_loss_fn(model, v1, n_global):
    """``examples/train_evolvegcn.py``'s closure loss, as ``main`` defines
    it."""

    def loss_fn(params, batch):
        state = model.init_state(params, mode=v1.level)
        _, outs = jrun_plan(model, params, state, batch["window"], v1)
        emb_local = outs[-1]
        ren = batch["last_renumber"]
        idx = jnp.where(ren >= 0, ren, n_global)
        glob = jnp.zeros((n_global + 1, emb_local.shape[1]))
        glob = glob.at[idx].set(emb_local * batch["last_mask"][:, None],
                                mode="drop")

        def score(pairs):
            return (glob[pairs[:, 0]] * glob[pairs[:, 1]]).sum(-1)

        pos, neg = score(batch["pos"]), score(batch["neg"])
        return (jnp.mean(jax.nn.softplus(-pos)) +
                jnp.mean(jax.nn.softplus(neg)))

    return loss_fn


def _port(world):
    tg, _, _, _, params, _ = world
    _, ft, snaps, model, _, v1 = tex.setup("cpu")
    pt = params_from_jax(EVOLVEGCN, params)
    return ft, snaps, model, pt, v1, tg.n_global_nodes


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_batches_equal_the_jax_example_bit_for_bit(world):
    tg, ft, snaps, _, _, _ = world
    tft, tsnaps = tex.setup("cpu")[1:3]
    np.testing.assert_array_equal(tft, ft)
    want = list(jex.build_batches(tg, ft, snaps, 5, seed=3))
    got = list(tex.build_batches(tg, tft, tsnaps, 5, seed=3, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for f in ("src", "dst", "coef", "edge_feat", "neigh_idx",
                  "neigh_coef", "neigh_eidx", "node_feat", "node_mask",
                  "renumber", "n_nodes", "n_edges"):
            np.testing.assert_array_equal(_np(getattr(g["window"], f)),
                                          _np(getattr(w["window"], f)))
        for key in ("pos", "neg", "last_renumber", "last_mask"):
            np.testing.assert_array_equal(_np(g[key]), _np(w[key]))
        assert g["pos"].dtype == g["neg"].dtype == torch.int64
        assert g["window"].node_feat.device.type == "cpu"


def test_first_batch_loss_and_grads_match_jax(world):
    tg, ft, snaps, model, params, v1 = world
    batch = next(jex.build_batches(tg, ft, snaps, 1))
    want_loss, want = jax.value_and_grad(
        _jax_loss_fn(model, v1, tg.n_global_nodes))(_jax(params), batch)
    want = [np.asarray(g) for g in jax.tree.leaves(want)]

    tft, tsnaps, tmodel, pt, tv1, n_global = _port(world)
    tbatch = next(tex.build_batches(tg, tft, tsnaps, 1, device="cpu"))
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    loss = tex.make_loss_fn(tmodel, tv1, n_global)(pt, tbatch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        TOL_LOSS * abs(float(want_loss))
    assert len(grads) == len(want) == 12
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= \
            TOL_GRAD * np.abs(w).max()


def _jax_opt(steps):
    return JAdamWConfig(lr=3e-3, weight_decay=0.01, warmup_steps=20,
                        total_steps=steps)


def _final_state(ckpt, step, pt):
    """A loop's final checkpoint, read into the port's template."""
    template = {"params": pt,
                "opt": init_opt_state(pt, tex.optimizer(STEPS))}
    return CheckpointManager(str(ckpt)).restore(step, template)


def _leaves_close(got, want, tol):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g).astype(np.float64), _np(w).astype(np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


@pytest.fixture(scope="module")
def four_steps(world, tmp_path_factory):
    """Both loops, STEPS steps each, checkpointed: (JAX result, port
    result, JAX final checkpoint, port final checkpoint)."""
    tg, ft, snaps, model, params, v1 = world
    jdir = tmp_path_factory.mktemp("jax_ckpt")
    tdir = tmp_path_factory.mktemp("port_ckpt")
    _, jres = jtrain(_jax_loss_fn(model, v1, tg.n_global_nodes),
                     _jax(params),
                     jex.build_batches(tg, ft, snaps, STEPS),
                     _jax_opt(STEPS),
                     JTrainLoopConfig(total_steps=STEPS, checkpoint_every=2,
                                      checkpoint_dir=str(jdir)))
    tft, tsnaps, tmodel, pt, tv1, n_global = _port(world)
    _, tres = train(tex.make_loss_fn(tmodel, tv1, n_global), pt,
                    tex.build_batches(tg, tft, tsnaps, STEPS, device="cpu"),
                    tex.optimizer(STEPS),
                    TrainLoopConfig(total_steps=STEPS, checkpoint_every=2,
                                    checkpoint_dir=str(tdir)),
                    device="cpu")
    template = _port(world)[3]
    return (jres, tres, _final_state(jdir, STEPS, template),
            _final_state(tdir, STEPS, template))


def test_four_adamw_steps_match_jax(four_steps):
    jres, tres, jstate, tstate = four_steps
    assert tres.final_step == jres.final_step == STEPS
    assert len(tres.losses) == len(jres.losses) == STEPS
    for got, want in zip(tres.losses, jres.losses):
        assert np.isfinite(got) and abs(got - want) <= TOL_LOSS * abs(want)
    _leaves_close(tstate["params"], jstate["params"], TOL_STATE)
    for key in ("m", "v"):
        _leaves_close(tstate["opt"][key], jstate["opt"][key], TOL_STATE)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == STEPS


def test_resume_from_a_checkpoint_matches_jax(world, four_steps, tmp_path):
    """The port's step-4 checkpoint resumed by both loops, to step 6."""
    jres, tres, _, _ = four_steps
    tg, ft, snaps, model, params, v1 = world
    tdir = tmp_path / "port"
    tft, tsnaps, tmodel, pt, tv1, n_global = _port(world)
    cfg = dict(total_steps=STEPS, checkpoint_every=2,
               checkpoint_dir=str(tdir))
    _, first = train(tex.make_loss_fn(tmodel, tv1, n_global), pt,
                     tex.build_batches(tg, tft, tsnaps, STEPS, device="cpu"),
                     tex.optimizer(6), TrainLoopConfig(**cfg), device="cpu")
    assert first.resumed_from is None and first.final_step == STEPS
    saved = _final_state(tdir, STEPS, _port(world)[3])
    _leaves_close(saved["params"], pt, 0.0)  # the trained tensors, exact
    jdir = tmp_path / "jax"
    shutil.copytree(tdir, jdir)
    cfg["total_steps"] = 6
    _, resumed = train(tex.make_loss_fn(tmodel, tv1, n_global),
                       _port(world)[3],
                       tex.build_batches(tg, tft, tsnaps, 6, device="cpu"),
                       tex.optimizer(6), TrainLoopConfig(**cfg), device="cpu")
    _, jresumed = jtrain(_jax_loss_fn(model, v1, tg.n_global_nodes),
                         _jax(params),
                         jex.build_batches(tg, ft, snaps, 6), _jax_opt(6),
                         JTrainLoopConfig(total_steps=6, checkpoint_every=2,
                                          checkpoint_dir=str(jdir)))
    assert resumed.resumed_from == jresumed.resumed_from == STEPS
    assert resumed.final_step == jresumed.final_step == 6
    assert len(resumed.losses) == len(jresumed.losses) == 2
    for got, want in zip(resumed.losses, jresumed.losses):
        assert abs(got - want) <= TOL_LOSS * abs(want)


def test_main_runs_on_the_cpu(tmp_path, capsys):
    tex.main(["--steps", "3", "--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed_from=None steps=3"
    assert out[1].startswith("loss: first10=") and "last10=" in out[1]
    assert out[2].startswith("mean step time: ") and \
        out[2].endswith("stragglers: 0")
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_the_default_checkpoint_is_not_the_jax_example_s():
    assert tex.DEFAULT_CKPT != "/tmp/evolvegcn_ckpt"
    assert Path(tex.DEFAULT_CKPT).name == "evolvegcn_torch_ckpt"


def test_the_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.main(["--steps", "1"])
