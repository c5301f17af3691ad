"""The port's Mamba2 mixer and MoE MLP compute the JAX package's.

On the CPU, at the ``reduce_for_smoke`` sizes of the four architectures
that use them (mamba2-2.7b, jamba-v0.1-52b, granite-moe-3b-a800m,
llama4-maverick-400b-a17b), with the JAX package's parameters carried
across by ``params.lm_params_from_jax`` and the same numpy inputs:

* the parameter layout at full width (JAX by ``jax.eval_shape``, the port
  on the ``meta`` device), fp32 and bf16, and the decode caches' layout;
* ``nn/moe.py``: ``_route`` (gates within 1e-6, the same experts),
  ``_moe_dense`` and ``moe_block`` (with llama4's shared expert), also
  under ``set_lowmem_norm``; the expert-parallel path's typed refusal
  without a mesh, and its run under the port's host mesh;
* ``nn/mamba2.py``: ``ssd_chunked`` in fp32 (within 1e-5 of max |y|; S a
  multiple of the chunk or not), also under ``set_ssd_bf16``;
  ``mamba_block``'s prefill, its handoff state, and decode steps from it;
* ``prefill_step``, ``decode_step``, ``generate`` and ``loss_fn`` of the
  four models, and the gradients of the reduced mamba2 and granite.

Tolerances are ``tests/test_torch_lm.py``'s: logits within ``TOL`` =
2e-2 of max |logits| over the real vocabulary, a generated token checked
where JAX's top-2 margin exceeds that; training's loss within 1e-3
relative and each gradient leaf within 3e-2 of its max |value|
(``tests/test_torch_train.py``). The sublayers compute in bf16 as the
JAX package does, with ``jax.nn.silu``'s formula (``layers.silu``), so
the blocks, and decode of all four models, measure bit for bit equal;
block outputs are held within one bf16 ulp (2^-8) of max |value|.

The JAX reference runs its unrolled layer loop (``scan_layers=False``):
its scanned loop compiles the layers' body, where XLA fuses bf16 chains
and keeps their excess precision, so the JAX package's two loops differ
(measured: prefill logits 2.9e-2 of max |logits| apart on the reduced
jamba's 16 layers, 1.0e-2 on mamba2's). The port rounds op by op, as
the unrolled loop does: measured 0 for mamba2, granite and llama4, and
8.9e-3 for jamba (its attention layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.nn import layers as jlayers
from repro.nn import mamba2 as jssm
from repro.nn import moe as jmoe
from repro.serve import lm_serve as jserve
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch import optim as to
from repro_torch.nn import attention as tattention
from repro_torch.nn import layers as tlayers
from repro_torch.nn import mamba2 as tssm
from repro_torch.nn import moe as tmoe
from repro_torch.params import lm_params_from_jax
from repro_torch.serve import generate

TOL = 2e-2
TOL_LOSS = 1e-3
TOL_GRAD = 3e-2
ULP = 2.0 ** -8
ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b", "granite-moe-3b-a800m",
         "llama4-maverick-400b-a17b"]
MOE_ARCHS = ["jamba-v0.1-52b", "granite-moe-3b-a800m",
             "llama4-maverick-400b-a17b"]
SSM_ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]


def _smoke(name):
    return jcfg.reduce_for_smoke(jcfg.ARCHS[name]), \
        tcfg.reduce_for_smoke(tcfg.ARCHS[name])


def _params(name, **rt_kw):
    """(JAX cfg, port cfg, JAX params, port params, JAX rt, port rt), the
    JAX rt on its unrolled layer loop."""
    jc, tc = _smoke(name)
    jrt = jm.RuntimeConfig(scan_layers=False, **rt_kw)
    trt = tm.RuntimeConfig(**rt_kw)
    pj, _ = jm.init_params(jc, jrt, jax.random.PRNGKey(1))
    pt = lm_params_from_jax(tc, trt, jax.tree.map(np.asarray, pj))
    return jc, tc, pj, pt, jrt, trt


def _tokens(cfg, b, s, seed=0):
    a = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}


def _close(got, want, vocab):
    """Logits over the real vocabulary within TOL of max |want|."""
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= TOL * np.abs(want).max(), err


def _within_ulp(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= ULP * np.abs(want).max()


def _tree(pj):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)


# -------------------------------------------------------------- layout ----

def _layout(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}.{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = (tuple(t.shape),
                         str(t.dtype).removeprefix("torch."))
    walk(tree, "")
    return out


@pytest.mark.parametrize("param_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ARCHS)
def test_init_params_layout_at_full_width(name, param_dtype):
    want = jax.eval_shape(
        lambda key: jm.init_params(
            jcfg.ARCHS[name], jm.RuntimeConfig(param_dtype=param_dtype),
            key)[0], jax.random.PRNGKey(0))
    got = tm.init_params(tcfg.ARCHS[name],
                         tm.RuntimeConfig(param_dtype=param_dtype),
                         device="meta")
    assert _layout(got) == _layout(want)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_caches_are_the_jax_layout(name):
    jc, tc = _smoke(name)
    want = jm.init_caches(jc, jm.RuntimeConfig(), 2, 16)
    got = tm.init_caches(tc, tm.RuntimeConfig(), 2, 16, device="cpu")
    assert _layout(got) == _layout(want)
    for pos, (mixer, _) in enumerate(tc.layer_kinds()[:tc.scan_period()]):
        assert set(got[pos]) == ({"k", "v", "len"} if mixer == "attn"
                                 else {"conv", "ssm"})
        if mixer == "ssm":
            assert not got[pos]["conv"].any() and not got[pos]["ssm"].any()


# ----------------------------------------------------------------- MoE ----

def _moe_case(name, seed=0):
    jc, tc = _smoke(name)
    pj, _ = jmoe.init_moe(jax.random.PRNGKey(3), jc, 1)
    x = np.random.default_rng(seed).normal(
        size=(2, 13, jc.d_model)).astype(np.float32)
    return jc, tc, pj, _tree(pj), jnp.asarray(x, jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture(params=[False, True], ids=["fp32-norms", "lowmem"])
def lowmem(request):
    jlayers.set_lowmem_norm(request.param)
    tlayers.set_lowmem_norm(request.param)
    yield request.param
    jlayers.set_lowmem_norm(False)
    tlayers.set_lowmem_norm(False)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_route_matches_jax(name, lowmem):
    jc, tc, pj, pt, xj, xt = _moe_case(name)
    gj, ej = jmoe._route(pj["router"], xj.reshape(-1, jc.d_model), jc)
    gt, et = tmoe._route(pt["router"], xt.reshape(-1, tc.d_model), tc)
    assert gt.dtype == torch.float32 and gt.shape == (26, tc.top_k)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
    np.testing.assert_allclose(gt.sum(-1).numpy(), 1.0, atol=1e-6)


def test_padded_experts_are_never_routed():
    """tp 3 pads granite's 4 reduced experts to 6; the padding's logits
    are masked, so no token goes there."""
    jc, tc = _smoke("granite-moe-3b-a800m")
    assert tc.padded_experts(3) == 6
    pj, _ = jmoe.init_moe(jax.random.PRNGKey(3), jc, 3)
    pt = _tree(pj)
    pt["router"][:, 4:] = 10.0  # padding would win without the mask
    x = torch.randn((64, tc.d_model), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    _, eidx = tmoe._route(pt["router"], x, tc)
    assert int(eidx.max()) < tc.n_experts
    y = tmoe.moe_block(pt, tc, x[None], impl="dense")
    want = jmoe.moe_block(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                       pt), jc,
                          jnp.asarray(x.float().numpy(), jnp.bfloat16)[None],
                          impl="dense")
    _within_ulp(y, want)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_dense_and_block_match_jax(name, lowmem):
    jc, tc, pj, pt, xj, xt = _moe_case(name, seed=1)
    _within_ulp(tmoe._moe_dense(pt, tc, xt), jmoe._moe_dense(pj, jc, xj))
    got = tmoe.moe_block(pt, tc, xt, impl="dense")
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    _within_ulp(got, jmoe.moe_block(pj, jc, xj, impl="dense"))
    assert ("shared" in pt) == (name == "llama4-maverick-400b-a17b")
    # the auto path on one card is the dense one
    assert torch.equal(tmoe.moe_block(pt, tc, xt), got)


@pytest.fixture
def host_mesh():
    """The port's 1x1 mesh on a world-1 ``gloo`` group of this process,
    torn down after the test."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_expert_parallel_moe_is_refused(host_mesh):
    """The expert-parallel path (the name is the one this case had while
    it was refused outright): without a mesh ``impl="ep"`` raises the typed
    error, under the host mesh it runs (the block equal to the dense path
    at ample capacity, prefill within TOL of the JAX package's ep prefill
    under its host mesh); an unknown impl still raises."""
    from jax.sharding import Mesh

    from repro.distributed.api import sharding_ctx as jctx
    from repro.launch.mesh import make_host_mesh as jhost
    from repro_torch.distributed.api import sharding_ctx

    _, tc, _, pt, _, xt = _moe_case("granite-moe-3b-a800m")
    with pytest.raises(tmoe.MeshRequiredError, match="needs a mesh"):
        tmoe.moe_block(pt, tc, xt, impl="ep")
    with pytest.raises(ValueError, match="moe impl"):
        tmoe.moe_block(pt, tc, xt, impl="sparse")
    stats = {}
    with sharding_ctx(host_mesh):
        ep = tmoe.moe_block(pt, tc, xt, impl="ep", cf_send=4.0,
                            cf_local=4.0, stats=stats)
        with pytest.raises(ValueError, match="moe impl"):
            tmoe.moe_block(pt, tc, xt, impl="sparse")
    assert [int(d) for d in stats["dropped"]] == [0]
    _within_ulp(ep, tmoe.moe_block(pt, tc, xt, impl="dense").float())
    # and through the model's runtime config
    jc, tc, pj, pt, jrt, trt = _params("granite-moe-3b-a800m",
                                       moe_impl="ep")
    bj, bt = _tokens(tc, 2, 8)
    with pytest.raises(tmoe.MeshRequiredError, match="needs a mesh"):
        tm.prefill_step(pt, tc, trt, bt, device="cpu")
    with sharding_ctx(host_mesh):
        got = tm.prefill_step(pt, tc, trt, bt, device="cpu")
    jmesh = jhost()
    assert isinstance(jmesh, Mesh)
    with jctx(jmesh):
        # jitted: eagerly, each layer's shard_map compiles on its own
        want = jax.jit(lambda p, b: jm.prefill_step(p, jc, jrt, b))(pj, bj)
    _close(got.float().numpy(), want, tc.vocab_size)


# -------------------------------------------------------------- Mamba2 ----

def _ssd_inputs(b, s, h, p, g, n, seed=0):
    r = np.random.default_rng(seed)
    xh = r.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(r.normal(size=h) * 0.3)).astype(np.float32)
    Bm = (r.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (r.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.fixture(params=[False, True], ids=["fp32", "ssd-bf16"])
def ssd_bf16(request):
    jssm.set_ssd_bf16(request.param)
    tssm.set_ssd_bf16(request.param)
    yield request.param
    jssm.set_ssd_bf16(False)
    tssm.set_ssd_bf16(False)


@pytest.mark.parametrize("s,chunk,g", [(32, 8, 1), (21, 8, 1), (40, 16, 2),
                                       (5, 8, 1)])
def test_ssd_chunked_matches_jax(s, chunk, g, ssd_bf16):
    args = _ssd_inputs(2, s, 4, 8, g, 16, seed=s)
    yj, fj = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    yt, ft = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert yt.shape == (2, s, 4, 8) and ft.shape == (2, 4, 8, 16)
    yj, fj = np.asarray(yj, np.float32), np.asarray(fj, np.float32)
    assert np.abs(yt.numpy() - yj).max() <= 1e-5 * np.abs(yj).max()
    assert np.abs(ft.numpy() - fj).max() <= 1e-5 * np.abs(fj).max()


def _naive_ssm(xh, dt, A, Bm, Cm):
    """The recurrence step by step in float64 (tests/test_mamba.py's
    oracle): (y, final state)."""
    b, s, h, p = xh.shape
    rep = h // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    state = np.zeros((b, h, p, Bm.shape[3]))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        upd = np.einsum("bhn,bh,bhp->bhpn", Bh[:, t], dt[:, t], xh[:, t])
        state = state * np.exp(dt[:, t] * A)[:, :, None, None] + upd
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ch[:, t], state)
    return ys, state


def test_ssd_padding_leaves_the_final_state_untouched():
    """S 21 pads to 24 with dt 0 steps: the final state is the
    recurrence's after step 21 (within 1e-5, fp32), and the outputs are
    its first 21 (within 1e-2 of max |y|: the intra-chunk scores and
    inputs are rounded to bf16, as in the JAX package)."""
    args = _ssd_inputs(2, 21, 4, 8, 1, 16)
    y, final = tssm.ssd_chunked(*map(torch.from_numpy, args), 8)
    want_y, want_final = _naive_ssm(*args)
    assert y.shape == want_y.shape
    assert np.abs(final.numpy() - want_final).max() <= \
        1e-5 * np.abs(want_final).max()
    assert np.abs(y.numpy() - want_y).max() <= 1e-2 * np.abs(want_y).max()


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_mamba_block_prefill_then_decode_match_jax(name, lowmem):
    jc, tc = _smoke(name)
    pj, _ = jssm.init_mamba(jax.random.PRNGKey(4), jc)
    pt = _tree(pj)
    x = np.random.default_rng(5).normal(
        size=(2, 19, jc.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    yj, sj = jssm.mamba_block(pj, jc, xj[:, :16])
    yt, st = tssm.mamba_block(pt, tc, xt[:, :16])
    _within_ulp(yt, yj)
    assert st["conv"].dtype == torch.bfloat16
    assert st["conv"].shape == (2, tc.ssm_conv - 1, tc.d_inner
                                + 2 * tc.ssm_ngroups * tc.ssm_state)
    np.testing.assert_array_equal(st["conv"].float().numpy(),
                                  np.asarray(sj["conv"], np.float32))
    _within_ulp(st["ssm"], sj["ssm"])
    # three decode steps from the prefill's state
    for i in range(16, 19):
        yj, sj = jssm.mamba_block(pj, jc, xj[:, i:i + 1], state=sj)
        yt, st = tssm.mamba_block(pt, tc, xt[:, i:i + 1], state=st)
        _within_ulp(yt, yj)
        _within_ulp(st["ssm"], sj["ssm"])
    # and decode continues the prefill: the last step's output is the
    # prefill's of all 19 positions
    full, _ = tssm.mamba_block(pt, tc, xt)
    err = (yt[:, 0].float() - full[:, -1].float()).abs().max()
    assert float(err) <= 4 * ULP * float(full[:, -1].float().abs().max())


def test_mamba_state_init_is_the_jax_layout():
    jc, tc = _smoke("mamba2-2.7b")
    want = jssm.init_mamba_state(jc, 3)
    got = tssm.init_mamba_state(tc, 3, device="cpu")
    assert _layout(got) == _layout(want)


# -------------------------------------------------------------- models ----

@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_jax(name):
    jc, tc, pj, pt, jrt, trt = _params(name)
    bj, bt = _tokens(jc, 2, 21)   # S 21: the chunked scan pads (chunk 8)
    want = jm.prefill_step(pj, jc, jrt, bj)
    got = tm.prefill_step(pt, tc, trt, bt, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want, jc.vocab_size)


def test_prefill_in_bf16_params():
    jc, tc, pj, pt, jrt, trt = _params("jamba-v0.1-52b", param_dtype="bf16")
    assert all(t.dtype == torch.bfloat16 for t in to.tree_leaves(pt))
    bj, bt = _tokens(jc, 2, 16, seed=1)
    _close(tm.prefill_step(pt, tc, trt, bt, device="cpu").numpy(),
           jm.prefill_step(pj, jc, jrt, bj), jc.vocab_size)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_jax(name):
    jc, tc, pj, pt, jrt, trt = _params(name)
    cj = jm.init_caches(jc, jrt, 2, 8)
    ct = tm.init_caches(tc, trt, 2, 8, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(3):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = jm.decode_step(pj, jc, jrt, jnp.asarray(tok), cj)
        lt, ct = tm.decode_step(pt, tc, trt, torch.from_numpy(tok), ct,
                                device="cpu")
        _close(lt.numpy(), lj, jc.vocab_size)
        for pos, (mixer, _) in enumerate(tc.layer_kinds()[:len(ct)]):
            if mixer == "ssm":
                for key in ("conv", "ssm"):
                    want = np.asarray(cj[pos][key], np.float32)
                    got = ct[pos][key].float().numpy()
                    assert np.abs(got - want).max() <= \
                        TOL * np.abs(want).max()


def test_ssm_only_decode_reads_no_cache_length(monkeypatch):
    """mamba2's caches have no "len"; the attention's position read is
    never reached."""
    _, tc, _, pt, _, trt = _params("mamba2-2.7b")

    def unreachable(*a, **k):
        raise AssertionError("an SSM layer read a KV position")

    monkeypatch.setattr(tattention, "_cache_pos", unreachable)
    caches = tm.init_caches(tc, trt, 2, 8, device="cpu")
    assert all("len" not in c for c in caches)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(3):
        logits, caches = tm.decode_step(pt, tc, trt, tok, caches,
                                        device="cpu")
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("name", ["mamba2-2.7b", "granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b"])
def test_decode_matches_prefill_of_the_same_prompt(name):
    """After the last prompt token, decode's logits are the prefill's of
    the whole prompt (both in the port; measured 6.5e-3 of max |logits|
    for mamba2, 0 for the MoE models). Not jamba: in the JAX package
    itself its decode and prefill are 2.9e-2 apart (the chunked scan's
    bf16 scores against the fp32 recurrence, through 16 layers), and the
    port's equal the JAX package's (the tests above)."""
    _, tc, _, pt, _, trt = _params(name)
    _, bt = _tokens(tc, 2, 12, seed=3)
    prefill = tm.prefill_step(pt, tc, trt, bt, device="cpu")
    caches = tm.init_caches(tc, trt, 2, 16, device="cpu")
    for i in range(12):
        logits, caches = tm.decode_step(pt, tc, trt, bt["tokens"][:, i:i + 1],
                                        caches, device="cpu")
    _close(logits.numpy(), prefill.numpy(), tc.vocab_size)


def _rel_gap(got, want, vocab):
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("depth", [1, 4, 16])
def test_mamba2_decode_drifts_from_prefill_as_in_jax(depth):
    """The gap between mamba2's decode after the prompt and the prefill of
    the prompt grows with depth in the JAX package itself, and the port's
    is the same gap: the reduced mamba2 (chunk 8, a 16-token prompt) at
    ``depth`` layers, each package's decode against its own prefill (JAX's
    unrolled layer loop), of max |logits|. Measured: JAX 5.93e-3, 1.154e-2
    and 3.704e-2 at 1, 4 and 16 layers, the port the same to the digits
    shown; the gap is the algorithm's (the chunked scan's bf16 scores
    against the fp32 recurrence), not the port's."""
    jc, tc = _smoke("mamba2-2.7b")
    jc = dataclasses.replace(jc, n_layers=depth)
    tc = dataclasses.replace(tc, n_layers=depth)
    jrt, trt = jm.RuntimeConfig(scan_layers=False), tm.RuntimeConfig()
    pj, _ = jm.init_params(jc, jrt, jax.random.PRNGKey(1))
    pt = lm_params_from_jax(tc, trt, jax.tree.map(np.asarray, pj))
    bj, bt = _tokens(jc, 2, 16, seed=3)
    pre_j = jm.prefill_step(pj, jc, jrt, bj)
    pre_t = tm.prefill_step(pt, tc, trt, bt, device="cpu")
    cj = jm.init_caches(jc, jrt, 2, 16)
    ct = tm.init_caches(tc, trt, 2, 16, device="cpu")
    for i in range(16):
        dec_j, cj = jm.decode_step(pj, jc, jrt, bj["tokens"][:, i:i + 1], cj)
        dec_t, ct = tm.decode_step(pt, tc, trt, bt["tokens"][:, i:i + 1], ct,
                                   device="cpu")
    gap_j = _rel_gap(dec_j[:, -1], pre_j[:, -1], jc.vocab_size)
    gap_t = _rel_gap(dec_t[:, -1].numpy(), pre_t[:, -1].numpy(),
                     tc.vocab_size)
    print(f"mamba2 reduced, {depth} layers: decode vs prefill, JAX "
          f"{gap_j:.4e}, port {gap_t:.4e}")
    assert np.isfinite(gap_j) and np.isfinite(gap_t)
    assert abs(gap_t - gap_j) <= 0.1 * gap_j
    if depth == 16:
        # past TOL in the JAX package itself
        assert gap_j > TOL


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_jax(name):
    jc, tc, pj, pt, jrt, trt = _params(name)
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


# ------------------------------------------------------------ training ----

RT_TRAIN = dict(loss_chunk=16, moe_impl="dense")


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())})


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_jax(name):
    jc, tc, pj, pt, jrt, trt = _params(name, **RT_TRAIN)
    bj, bt = _batch(jc)
    want = float(jm.loss_fn(pj, jc, jrt, bj))
    with torch.no_grad():
        got = float(tm.loss_fn(pt, tc, trt, bt, device="cpu"))
    assert np.isfinite(got) and abs(got - want) <= TOL_LOSS * abs(want)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["mamba2-2.7b", "granite-moe-3b-a800m"])
def test_loss_and_grads_match_jax(name, remat):
    jc, tc, pj, pt, jrt, trt = _params(name, remat=remat, **RT_TRAIN)
    bj, bt = _batch(jc, seed=1)
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jc, jrt, bj))(pj)
    want = [np.asarray(g, np.float32) for g in jax.tree.leaves(want)]
    leaves = to.tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss_fn(pt, tc, trt, bt, device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        TOL_LOSS * abs(float(want_loss))
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        err = float(np.abs(got.float().numpy() - w).max())
        assert np.isfinite(err) and err <= TOL_GRAD * np.abs(w).max()


def test_lm_params_from_jax_covers_the_new_leaves():
    _, _, _, pt, _, _ = _params("llama4-maverick-400b-a17b")
    moe = next(b["moe"] for b in pt["blocks"] if "moe" in b)
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    _, tc, pj, pt, _, trt = _params("mamba2-2.7b")
    assert set(pt["blocks"][0]["ssm"]) == {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "ssm_norm",
        "out_proj"}
    bad = jax.tree.map(np.asarray, pj)
    bad["blocks"][0]["ssm"].pop("dt_bias")
    with pytest.raises(ValueError, match="expected keys"):
        lm_params_from_jax(tc, trt, bad)
