"""EvolveGCN-O's edge terms: the edge-term kernel (``engine.edge_terms``,
csrc/edge_terms.cu) and the torch path it replaces on the card.

* On the CPU the wrapper runs its plain version: the torch path's terms
  (``ref.evolve_edge_terms``) in the square layout the evolve engine reads,
  zeros past each layer's width and on rows at or past ``n_nodes``. The
  CPU and ``force_ref`` sessions take the torch path and launch nothing.
* The square layout runs the oracle and the engine's plain version to the
  bits of the per-layer terms it holds, solo and batched: layer l in slot
  l, its first din_l columns read, the rest never.
* On a card (skipped here): the kernel is ``torch.equal`` to the torch
  path at the benchmark's shape (B 16, ragged T, n 640, k 64, De 8, din 64
  / 128) and at narrow odd ones; its bits do not depend on the launch's B
  and T; a session call launches it once and serves the bits it served
  with the torch path's terms.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs.dgnn import EVOLVEGCN
from repro_torch.core.evolvegcn import layer_dims
from repro_torch.graph.coo import COOSnapshot
from repro_torch.graph.csr import renumber_and_normalize
from repro_torch.graph.padding import (pad_snapshot, stack_ragged,
                                       stack_streams)
from repro_torch.kernels import engine, ref
from repro_torch.kernels import ops as tops

CFG = dataclasses.replace(EVOLVEGCN, in_dim=8, hidden=16, out_dim=8,
                          edge_dim=4)
N_GLOBAL, N_PAD, E_PAD, K_MAX = 48, 32, 128, 16

#: (B, T, n, k, E, De, dins, D, n_nodes rule): the benchmark's shape, and
#: narrow odd ones (k 1, n not a multiple of the kernel's 32-row block,
#: din 13 across a float4, De 3)
CASES = {
    "bench": (16, 192, 640, 64, 4096, 8, (64, 128), 128, "ragged"),
    "k1": (2, 3, 37, 1, 20, 8, (64, 128), 128, "mixed"),
    "odd": (3, 4, 37, 27, 50, 3, (13, 24), 24, "mixed"),
    "rows33": (1, 2, 33, 5, 40, 8, (8, 16), 16, "full"),
}


def _case(name, device, seed=0):
    """(eidx, coef, feat, n_nodes, w_edge, D) of a case: rows v < n_nodes
    hold live lanes up to a random degree (coef 0 on some of them, and on
    the lanes past it, which read row 0 as padding does), rows past
    n_nodes are padding; "mixed" has an empty snapshot, "ragged" repeats
    the last snapshot of half the streams as ``stack_ragged`` does."""
    B, T, n, k, E, De, dins, D, rule = CASES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=g, device=device)
    if rule == "full":
        n_nodes = torch.full((B, T), n, dtype=torch.int32, device=device)
    else:
        n_nodes = (rand(B, T) * (n + 1)).to(torch.int32)
        if rule == "mixed":
            n_nodes[0, 1] = 0
    deg = (rand(B, T, n) * (k + 1)).long()
    lane = torch.arange(k, device=device)
    live = ((lane < deg[..., None])
            & (torch.arange(n, device=device)[:, None]
               < n_nodes[..., None, None].long()))
    eidx = torch.where(live, (rand(B, T, n, k) * E).long(), 0).to(torch.int32)
    coef = torch.where(live & (rand(B, T, n, k) > 0.1),
                       rand(B, T, n, k) * 2 - 1, 0.0)
    feat = rand(B, T, E, De) * 4 - 2
    if rule == "ragged":
        for b in range(0, B, 2):  # a dead tail: the last snapshot repeated
            tail = T - 55
            for t_ in (eidx, coef, feat, n_nodes):
                t_[b, tail:] = t_[b, tail - 1:tail]
    w_edge = [rand(De, c) * 2 - 1 for c in dins]
    return eidx, coef, feat, n_nodes, w_edge, D


def _padded_torch_path(eidx, coef, feat, n_nodes, w_edge, D):
    """The torch path's terms, each layer zero-padded to D and stacked as
    the evolve pack stacks them; zeros on rows at or past n_nodes."""
    terms = ref.evolve_edge_terms(eidx, coef, feat, w_edge)
    rows = (torch.arange(eidx.shape[-2], device=eidx.device)[:, None]
            < n_nodes[..., None, None, None])
    return torch.where(rows, torch.stack([tops._pad_to(t, D, -1)
                                          for t in terms], dim=-3), 0.0)


@pytest.mark.parametrize("name", ["k1", "odd", "rows33"])
def test_plain_version_is_the_torch_path_in_the_square_layout(name):
    eidx, coef, feat, n_nodes, w_edge, D = _case(name, "cpu")
    engine.reset_launches()
    got = engine.edge_terms(eidx, coef, feat, n_nodes, w_edge, D)
    assert engine.LAUNCHES["edge_terms"] == 0
    B, T, n = eidx.shape[:3]
    assert got.shape == (B, T, len(w_edge), n, D)
    assert torch.equal(got, _padded_torch_path(eidx, coef, feat, n_nodes,
                                               w_edge, D))
    # padding rows carry coef 0, so their torch-path terms are zeros too
    terms = ref.evolve_edge_terms(eidx, coef, feat, w_edge)
    assert torch.equal(got, torch.stack([tops._pad_to(t, D, -1)
                                         for t in terms], dim=-3))
    for l, w in enumerate(w_edge):
        assert not got[:, :, l, :, w.shape[-1]:].any()


def test_wrapper_takes_cpu_or_cuda_tensors_only():
    eidx, coef, feat, n_nodes, w_edge, D = (
        a.to("meta") if torch.is_tensor(a) else a
        for a in _case("k1", "cpu"))
    with pytest.raises(ValueError, match="not supported"):
        engine.edge_terms(eidx, coef, feat, n_nodes, [w.to("meta")
                                                      for w in w_edge], D)


def _stream(rng, T, n_global=N_GLOBAL, din=8, de=4):
    feat = rng.standard_normal((n_global, din)).astype(np.float32)
    snaps = []
    for t in range(T):
        e = int(rng.integers(6, 20))
        ef = rng.standard_normal((e, de)).astype(np.float32)
        ls = renumber_and_normalize(COOSnapshot(
            rng.integers(0, n_global, e), rng.integers(0, n_global, e), ef,
            t))
        snaps.append(pad_snapshot(ls, feat, N_PAD, E_PAD, K_MAX))
    return stack_streams(snaps)


def _session(device, force_ref=False):
    return api.BoosterSession(CFG, api.plan(CFG, level="v3"),
                              n_global=N_GLOBAL,
                              gen=torch.Generator().manual_seed(0),
                              device=device, force_ref=force_ref)


@pytest.mark.parametrize("force_ref", [False, True])
def test_cpu_sessions_take_the_torch_path_and_launch_nothing(force_ref):
    rng = np.random.default_rng(3)
    streams = [_stream(rng, T).to("cpu") for T in (4, 3, 5)]
    sess = _session("cpu", force_ref)
    terms = sess.model._edge_aggs(sess.params, streams[0])
    s0 = streams[0]
    assert torch.equal(terms, _padded_torch_path(
        s0.neigh_eidx, s0.neigh_coef, s0.edge_feat, s0.n_nodes,
        [p["w_edge"] for p in sess.params["gcn"]],
        tops.square_width(layer_dims(CFG))))
    engine.reset_launches()
    sess.run(streams[0])
    sess.run_batched(streams)
    assert engine.LAUNCHES["edge_terms"] == 0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("force_ref", [False, True])
def test_packed_terms_run_like_the_list(batched, force_ref):
    """The (..., L, n, D) terms go through the pack (as they are) and
    through the force-ref oracle (each layer's slot cut to its width) to
    the bits of the per-layer list they hold: the same list written into
    a square tensor whose columns past each layer's width hold junk gives
    the same bits, so layer l is read from slot l, its first din_l
    columns only (the pack's padded weight rows zero the rest)."""
    rng = np.random.default_rng(4)
    streams = [_stream(rng, T).to("cpu") for T in (4, 3, 5)]
    sess = _session("cpu")
    m, p = sess.model, sess.params
    if batched:
        snaps, lens = stack_ragged(streams, "cpu")
        state = {"weights": [w[None].expand(len(lens), *w.shape).clone()
                             for w in sess.state["weights"]]}
    else:
        snaps, lens, state = streams[0], None, sess.state
    args = m.stream_args(p, state, snaps, force_ref=force_ref)
    terms = ref.evolve_edge_terms(snaps.neigh_eidx, snaps.neigh_coef,
                                  snaps.edge_feat,
                                  [q["w_edge"] for q in p["gcn"]])
    junk = torch.full_like(args[-1], 7.5)
    for l, t in enumerate(terms):
        junk[..., l, :, :t.shape[-1]] = t
    kw = dict(force_ref=force_ref, device="cpu")
    if batched:
        run = lambda a: tops.stream_steps_batched("evolve", *a, lengths=lens,
                                                  **kw)
    else:
        run = lambda a: tops.stream_steps("evolve", *a, **kw)
    want = run(args)
    got = run((*args[:-1], junk))
    assert torch.equal(got[0], want[0])
    for g_, w_ in zip(got[1], want[1]):
        assert torch.equal(g_, w_)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (python3 chip_smoke.py runs them)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_the_torch_path_bit_for_bit(cuda, name):
    inp = _case(name, cuda, seed=5)
    engine.reset_launches()
    got = engine.edge_terms(*inp)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["edge_terms"] == 1
    assert torch.equal(got, engine.edge_terms_plain(*inp))
    assert torch.equal(got, _padded_torch_path(*inp))


@pytest.mark.cuda
def test_kernel_bits_do_not_depend_on_the_launch(cuda):
    """The CUDA twin of the scheduler test's edge-term check: a stream's
    terms from a (B 3, T 8) launch equal those of its own T chunks."""
    eidx, coef, feat, n_nodes, w_edge, D = _case("odd", cuda, seed=6)
    whole = engine.edge_terms(eidx, coef, feat, n_nodes, w_edge, D)
    for b in range(eidx.shape[0]):
        for t0, t1 in ((0, 2), (2, 3), (3, 4)):
            part = engine.edge_terms(
                *(a[b:b + 1, t0:t1].contiguous()
                  for a in (eidx, coef, feat, n_nodes)), w_edge, D)
            assert torch.equal(part[0], whole[b, t0:t1]), (b, t0, t1)


@pytest.mark.cuda
def test_a_session_call_launches_it_once_and_keeps_its_bits(cuda,
                                                            monkeypatch):
    rng = np.random.default_rng(7)
    streams = [_stream(rng, T) for T in (4, 3, 5)]
    runs = {}
    for route in ("kernel", "torch path"):
        if route == "torch path":
            monkeypatch.setattr(engine, "edge_terms", engine.edge_terms_plain)
        sess = _session(cuda)
        engine.reset_launches()
        solo = sess.run(streams[0])
        assert engine.LAUNCHES["edge_terms"] == (route == "kernel")
        engine.reset_launches()
        states, outs = sess.run_batched(streams)
        assert engine.LAUNCHES["edge_terms"] == (route == "kernel")
        runs[route] = (solo, list(sess.state["weights"]), list(outs),
                       states)
    ref_sess = _session(cuda, force_ref=True)
    engine.reset_launches()
    ref_sess.run(streams[0])
    assert engine.LAUNCHES["edge_terms"] == 0
    got, want = runs["kernel"], runs["torch path"]
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def _route(route, device):
    """One evolve route's results (a flat list of tensors / arrays) on
    ``device``: run_arrays solo and ragged (the kernel route, and the
    force-ref oracle on the same arguments), the paged session, and the
    serve engine's tenants under either scheduler."""
    rng = np.random.default_rng(8)
    streams = [_stream(rng, T) for T in (4, 3, 5)]
    if route.startswith("serve"):
        kw = (dict(scheduler="continuous", state_pool_pages=2,
                   prefill_chunk=1) if route == "serve continuous" else {})
        plan = api.plan(CFG, level="v3", buckets=((N_PAD, E_PAD, K_MAX),),
                        stream_chunk=2, **kw)
        feat = rng.standard_normal((N_GLOBAL, CFG.in_dim)).astype(np.float32)
        sess = api.BoosterSession(CFG, plan, n_global=N_GLOBAL,
                                  feat_table=feat,
                                  gen=torch.Generator().manual_seed(0),
                                  device=device)
        coo = {sid: [COOSnapshot(rng.integers(0, N_GLOBAL, 9),
                                 rng.integers(0, N_GLOBAL, 9),
                                 rng.standard_normal((9, CFG.edge_dim))
                                 .astype(np.float32), t) for t in range(T)]
               for sid, T in zip("abc", (7, 3, 5))}
        _, outs, _ = sess.serve_multi(coo)
        return [torch.as_tensor(np.asarray(o)) for sid in sorted(outs)
                for o in outs[sid]]
    if route == "hbm_paged":
        plan = api.plan(CFG, level="v3", state_residency="hbm_paged", td=8,
                        buffer_depth=2)
        sess = api.BoosterSession(CFG, plan, n_global=N_GLOBAL,
                                  gen=torch.Generator().manual_seed(0),
                                  device=device)
        solo = sess.run(streams[0].to(device))
        states, outs = sess.run_batched(streams)
        return [solo, *sess.state["weights"], *outs]
    sess = _session(device)
    m, p = sess.model, sess.params
    solo = m.stream_args(p, m.init_state(p, mode="v3"),
                         streams[0].to(device))
    snaps, lens = stack_ragged(streams, device)
    state = {"weights": [w[None].expand(len(lens), *w.shape).clone()
                         for w in m.init_state(p, mode="v3")["weights"]]}
    batched = m.stream_args(p, state, snaps)
    got = []
    for force_ref in (False, True):
        a = api.run_arrays(api.plan(CFG, level="v3"), *solo,
                           force_ref=force_ref, device=device)
        b = api.run_arrays(api.plan(CFG, level="v3", batch=len(lens),
                                    lengths=tuple(lens)), *batched,
                           force_ref=force_ref, device=device)
        got += [a[0], *a[1], b[0], *b[1]]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["run_arrays", "hbm_paged", "serve rounds",
                                   "serve continuous"])
def test_every_evolve_route_keeps_its_bits(cuda, route, monkeypatch):
    """Each evolve route on the card serves the bits it served with the
    torch path's terms, and launches the kernel."""
    engine.reset_launches()
    got = _route(route, cuda)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["edge_terms"] > 0
    monkeypatch.setattr(engine, "edge_terms", engine.edge_terms_plain)
    want = _route(route, cuda)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
