"""Training the Mamba2 and MoE architectures: the SSD's per-chunk
recompute and the training launcher.

On the CPU, at small sizes:

* ``ssd_chunked``'s gradients with respect to all five inputs (x, dt, A,
  B, C) equal ``jax.grad`` of the JAX package's, for the cases of
  ``tests/test_torch_ssm_moe.py::test_ssd_chunked_matches_jax`` (S a
  multiple of the chunk or not), in fp32 and under ``set_ssd_bf16``:
  within ``TOL_GRAD`` of max |grad| of JAX run op by op
  (``jax.disable_jit``: measured <= 1.2e-6), and within ``TOL_GRAD_XLA``
  of JAX compiled (its ``lax.map`` body is one XLA computation whose fused
  backward keeps excess precision in the bf16 intra-chunk products, as
  its scanned layer loop does: measured <= 4.3e-3, about one bf16 ulp,
  on dt, A, B and C; dx <= 4.5e-7);
* the recompute: no tensor that autograd saves for ``ssd_chunked`` has a
  (q, q) pair of dims, and at a fixed S the saved bytes do not grow with
  the chunk length q (the same loop without the recompute, built here
  from the port's ``_per_chunk``, saves S x q per head and batch row, and
  the hooks see it); its gradients are bit for bit that loop's;
* ``python -m repro_torch.launch.train`` trains the reduced mamba2-2.7b
  and granite-moe-3b-a800m (with ``--attn-impl flash``: the kernels'
  plain versions on the CPU) for two steps to finite losses.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.nn import mamba2 as jssm
from repro_torch.launch import train as launch
from repro_torch.nn import mamba2 as tssm

#: gradients, of max |grad|: against JAX op by op, which rounds where the
#: port does; against JAX compiled, whose fused backward does not round
#: every bf16 intermediate (the module docstring's measurements)
TOL_GRAD = 1e-5
TOL_GRAD_XLA = 1e-2
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """tests/test_torch_ssm_moe.py's inputs: x, dt (softplus), A < 0, B, C."""
    r = np.random.default_rng(seed)
    xh = r.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(r.normal(size=h) * 0.3)).astype(np.float32)
    Bm = (r.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (r.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _cotangents(xh, Bm, seed):
    """Unit-normal weights of y (b, s, h, p) and of the final state
    (b, h, p, n): the loss is sum(y wy) + sum(final wf)."""
    r = np.random.default_rng(seed + 1000)
    b, s, h, p = xh.shape
    wy = r.normal(size=(b, s, h, p)).astype(np.float32)
    wf = r.normal(size=(b, h, p, Bm.shape[3])).astype(np.float32)
    return wy, wf


@pytest.fixture(params=[False, True], ids=["fp32", "ssd-bf16"])
def ssd_bf16(request):
    jssm.set_ssd_bf16(request.param)
    tssm.set_ssd_bf16(request.param)
    yield request.param
    jssm.set_ssd_bf16(False)
    tssm.set_ssd_bf16(False)


def _torch_grads(ssd, args, chunk, wy, wf):
    """The five input gradients of sum(y wy) + sum(final wf) through
    ``ssd`` (``tssm.ssd_chunked`` or the unrolled loop below)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, final = ssd(*leaves, chunk)
    loss = (y * torch.from_numpy(wy)).sum() \
        + (final * torch.from_numpy(wf)).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("s,chunk,g", [(32, 8, 1), (21, 8, 1), (40, 16, 2),
                                       (5, 8, 1)])
def test_ssd_chunked_grads_match_jax(s, chunk, g, ssd_bf16):
    args = _ssd_inputs(2, s, 4, 8, g, 16, seed=s)
    wy, wf = _cotangents(args[0], args[3], s)

    def jloss(*a):
        y, final = jssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * wy) + jnp.sum(final * wf)

    grad = jax.grad(jloss, argnums=tuple(range(5)))
    with jax.disable_jit():
        op_by_op = grad(*map(jnp.asarray, args))
    compiled = grad(*map(jnp.asarray, args))
    got = _torch_grads(tssm.ssd_chunked, args, chunk, wy, wf)
    for want, tol in ((op_by_op, TOL_GRAD), (compiled, TOL_GRAD_XLA)):
        for name, gt, gj, a in zip(NAMES, got, want, args):
            gj = np.asarray(gj, np.float32)
            assert gt.shape == a.shape and gj.shape == a.shape, name
            err = float(np.abs(gt.numpy() - gj).max())
            assert np.isfinite(err) and err <= tol * np.abs(gj).max(), \
                (name, tol, err, float(np.abs(gj).max()))


def _unrolled_ssd(xh, dt, A, Bm, Cm, chunk):
    """``tssm.ssd_chunked``'s loop with each ``_per_chunk`` called
    directly: every chunk's O(q^2) buffers kept for the backward."""
    b, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = xh.shape[1]
    rep = h // g
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    carry = torch.zeros((b, h, p, n), dtype=torch.float32)
    ys = []
    for c in range(s // chunk):
        cut = slice(c * chunk, (c + 1) * chunk)
        y_intra, state, cums = tssm._per_chunk(
            xh[:, cut], dt[:, cut], Bm[:, cut], Cm[:, cut], A, mask, rep)
        Ch = torch.repeat_interleave(Cm[:, cut], rep, dim=2)
        decay_from_start = torch.exp(cums)
        if tssm.SSD_BF16:
            y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", tssm._bf16(Ch),
                                   tssm._bf16(carry),
                                   tssm._bf16(decay_from_start))
        else:
            y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", Ch, carry,
                                   decay_from_start)
        ys.append(y_intra + y_inter)
        carry = carry * torch.exp(cums[:, -1, :])[:, :, None, None] + state
    return torch.cat(ys, dim=1)[:, :s_orig], carry


@pytest.mark.parametrize("s,chunk,g", [(32, 8, 1), (21, 8, 1), (40, 16, 2),
                                       (5, 8, 1)])
def test_ssd_recompute_grads_bit_for_bit_the_unrolled_loop(s, chunk, g,
                                                          ssd_bf16):
    args = _ssd_inputs(2, s, 4, 8, g, 16, seed=s)
    wy, wf = _cotangents(args[0], args[3], s)
    with torch.no_grad():
        y, final = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
        y_u, final_u = _unrolled_ssd(*map(torch.from_numpy, args), chunk)
    assert torch.equal(y, y_u) and torch.equal(final, final_u)
    got = _torch_grads(tssm.ssd_chunked, args, chunk, wy, wf)
    want = _torch_grads(_unrolled_ssd, args, chunk, wy, wf)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name


def _saved(ssd, s, chunk):
    """The shapes and the bytes of every tensor autograd saves while
    ``ssd`` runs forward at (b 2, S s, h 3, p 5, n 7): no dim but a
    (q, q) pair's equals a chunk length of the tests."""
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _ssd_inputs(2, s, 3, 5, 1, 7, seed=1)]
    shapes = []

    def pack(t):
        shapes.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, final = ssd(*args, chunk)
    # the graph is whole: a backward through it runs
    torch.autograd.grad(y.sum() + final.sum(), args)
    return shapes


def _has_square(shape, q):
    return sum(d == q for d in shape) >= 2


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_saves_no_chunk_square_buffer(chunk):
    """With the recompute no saved tensor has a (q, q) pair of dims; the
    unrolled loop saves the masked decay and the scores (b, q, q, h) of
    every chunk, which these hooks see."""
    kept = _saved(tssm.ssd_chunked, 64, chunk)
    assert kept and not any(_has_square(sh, chunk) for sh, _ in kept), kept
    unrolled = _saved(_unrolled_ssd, 64, chunk)
    squares = [sh for sh, _ in unrolled if _has_square(sh, chunk)]
    assert len(squares) >= 64 // chunk and (2, chunk, chunk, 3) in squares


def test_ssd_saved_bytes_do_not_grow_with_the_chunk():
    """At S 64 the saved bytes do not grow from q 4 to q 64 (the carried
    state a chunk and the chunk's O(q) terms: fewer chunks save less);
    without the recompute they grow as S x q."""
    s, chunks = 64, (4, 8, 16, 32, 64)
    kept = [sum(b for _, b in _saved(tssm.ssd_chunked, s, q)) for q in chunks]
    assert all(b <= kept[0] for b in kept[1:]), dict(zip(chunks, kept))
    unrolled = [sum(b for _, b in _saved(_unrolled_ssd, s, q))
                for q in chunks]
    assert all(a < b for a, b in zip(unrolled, unrolled[1:])), \
        dict(zip(chunks, unrolled))
    # at q 64 the (b, q, q, h) fp32 decay alone is 2 * 64 * 64 * 3 * 4 B
    assert unrolled[-1] - kept[-1] >= 2 * 64 * 64 * 3 * 4


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-2.7b", []),
    ("granite-moe-3b-a800m", ["--attn-impl", "flash"]),
], ids=["mamba2-2.7b", "granite-moe-3b-a800m-flash"])
def test_launch_train_trains_the_reduced_model(arch, extra, capsys):
    launch.main(["--arch", arch, "--device", "cpu", "--steps", "2", *extra])
    out = capsys.readouterr().out
    assert f"training {arch}-smoke" in out and "steps=2 " in out, out
    losses = re.search(r"loss first1=(\S+) last1=(\S+)", out)
    assert losses, out
    assert all(math.isfinite(float(v)) for v in losses.groups()), out


def _frame(path, line, name):
    return {"filename": path, "line": line, "name": name}


def test_train_step_memory_replays_the_peak():
    """tools/train_step_memory.py's replay of an allocator trace: the
    peak, the bytes live there by allocating frame (a block allocated
    before the trace and freed in it leaves that group) and by block size,
    and the frames of the allocation that reached it."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools/train_step_memory.py"
    spec = importlib.util.spec_from_file_location("train_step_memory", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ssd = _frame("/x/src/repro_torch/nn/mamba2.py", 140, "_per_chunk")
    adam = _frame("/x/src/repro_torch/optim/adamw.py", 360, "apply_updates")
    trace = [
        {"action": "alloc", "addr": 1, "size": 100, "frames": [ssd]},
        {"action": "alloc", "addr": 2, "size": 50, "frames": []},
        {"action": "free_requested", "addr": 1, "size": 100},
        {"action": "free_completed", "addr": 1, "size": 100},
        {"action": "free_completed", "addr": 9, "size": 30},
        {"action": "alloc", "addr": 3, "size": 200,
         "frames": [_frame("/t/torch/x.py", 1, "op"), adam]},
        {"action": "free_completed", "addr": 2, "size": 50},
    ]
    best, groups, blocks, frames = tool.peak_live(trace, 1000)
    assert best == 1220
    assert groups == {
        "(before the step)": 970,
        "(no Python frame: autograd's backward)": 50,
        "repro_torch/optim/adamw.py:360 apply_updates": 200}
    assert sum(groups.values()) == best
    assert blocks == {("(no Python frame: autograd's backward)", 50): 1,
                      ("repro_torch/optim/adamw.py:360 apply_updates",
                       200): 1}
    assert frames[1] is adam
