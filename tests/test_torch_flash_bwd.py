"""The port's flash attention backward computes the JAX package's.

``repro_torch.kernels.flash_attention.flash_mha`` (a
``torch.autograd.Function``: ``flash_fwd``, then ``flash_bwd``, whose
wrappers run the backward kernels' plain versions for CPU tensors) against
``jax.vjp`` of the JAX ``flash_mha`` in interpret mode (its Pallas
``_flash_dkv_kernel`` / ``_flash_dq_kernel``), on the same numpy q / k / v
and dO made from a seed: S 128 with bq = bk = 32 and S 256 with bq 64 /
bk 128, causal and full, group 1 and 4 with distinct K / V per kv head.
Tolerances: fp32 dq / dk / dv within 1e-4 of each one's max |value| (the
sums over S rows run in another order: the JAX kernels add q tile by q
tile, the plain versions a whole kv tile's rows at once); one bf16 case
within 2e-2 of max |value| (both round p and dS to bf16 before their
products, but at values that differ by the fp32 summation order, which
can move a rounding by one bf16 ulp, 2^-8 relative). The plain backward
functions match ``torch.autograd`` through ``flash_fwd_plain`` in fp32;
the backward refuses a tail as the forward does; and the forward and
backward kernel wrappers refuse inputs that need a gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import engine
from repro_torch.kernels import flash_attention as tfa

TOL_F32 = 1e-4
TOL_BF16 = 2e-2


def _case(seed, bh, s, d, group):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return (f32(bh, s, d), f32(bh // group, s, d), f32(bh // group, s, d),
            f32(bh, s, d))


def _t(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _jax_grads(q, k, v, do, causal, bq, bk, group, dtype=jnp.float32):
    q, k, v, do = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_mha(
        q_, k_, v_, causal, bq, bk, group, True), q, k, v)
    return [np.asarray(g, np.float32) for g in vjp(do)]


def _port_grads(q, k, v, do, causal, bq, bk, group, dtype=torch.float32):
    q, k, v, do = _t((q, k, v, do), dtype)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = tfa.flash_mha(q, k, v, causal, bq, bk, group)
    return [g.float().numpy() for g in torch.autograd.grad(o, (q, k, v),
                                                           do)]


def _assert_close(got, want, tol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert np.isfinite(g).all() and err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("s,bq,bk", [(128, 32, 32), (256, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_mha_grads_match_the_pallas_backward(s, bq, bk, causal, group):
    args = (*_case(10 + group, 2 * 2 * group, s, 32, group), causal, bq, bk,
            group)
    engine.reset_launches()
    got = _port_grads(*args)
    assert not any(engine.LAUNCHES.values())
    _assert_close(got, _jax_grads(*args), TOL_F32)


def test_flash_mha_grads_match_the_pallas_backward_in_bf16():
    args = (*_case(20, 10, 128, 32, 5), True, 32, 64, 5)
    got = _port_grads(*args, dtype=torch.bfloat16)
    _assert_close(got, _jax_grads(*args, dtype=jnp.bfloat16), TOL_BF16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_plain_backward_is_the_gradient_of_the_plain_forward(causal, group):
    """flash_bwd_dkv_plain / flash_bwd_dq_plain against torch.autograd
    through flash_fwd_plain, with delta = rowsum(dO o), in fp32."""
    q, k, v, do = _t(_case(30, 2 * group, 96, 16, group))
    for t in (q, k, v):
        t.requires_grad_(True)
    o, lse = tfa.flash_fwd_plain(q, k, v, causal, 32, 32, group)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta, causal, 32, 32, group)
        dk, dv = tfa.flash_bwd_dkv_plain(*args)
        dq = tfa.flash_bwd_dq_plain(*args)
    for got, w in zip((dq, dk, dv), want):
        assert float((got - w).abs().max()) <= TOL_F32 * float(w.abs().max())


@pytest.mark.parametrize("entry", ["flash_bwd_dkv", "flash_bwd_dq",
                                   "flash_bwd"])
def test_the_backward_refuses_a_tail(entry):
    """JAX's _flash_bwd grid is s // bq (and skv // bk), so a tile that
    does not divide the sequence leaves rows of dq / dk / dv unwritten;
    the port raises, on every backward entry point."""
    q, k, v, do = _t(_case(40, 4, 96, 16, 2))
    lse = torch.zeros((4, 96))
    call = {"flash_bwd_dkv": lambda bq, bk: tfa.flash_bwd_dkv(
                q, k, v, do, lse, lse, True, bq, bk, 2),
            "flash_bwd_dq": lambda bq, bk: tfa.flash_bwd_dq(
                q, k, v, do, lse, lse, True, bq, bk, 2),
            # (q, k, v, o, lse, dO): dO stands in for o
            "flash_bwd": lambda bq, bk: tfa.flash_bwd(
                q, k, v, do, lse, do, True, bq, bk, 2)}[entry]
    for bq, bk in ((64, 32), (32, 64)):
        with pytest.raises(ValueError, match="must divide"):
            call(bq, bk)
    call(32, 32)  # divides: runs


@pytest.mark.parametrize("entry", ["flash_attention", "flash_fwd",
                                   "flash_bwd_dkv", "flash_bwd_dq"])
def test_kernel_wrappers_refuse_an_input_that_needs_a_gradient(entry):
    """The wrappers record no gradient (on the card a kernel writes its
    outputs through a raw pointer), so they refuse where autograd is on,
    on the CPU too; under no_grad they run. flash_mha is the
    differentiable entry."""
    q, k, v, do = _t(_case(50, 4, 32, 16, 2))
    lse = torch.zeros((4, 32))
    args = {"flash_attention": (q, k, v),
            "flash_fwd": (q, k, v, True, 32, 32, 2),
            "flash_bwd_dkv": (q, k, v, do, lse, lse, True, 32, 32, 2),
            "flash_bwd_dq": (q, k, v, do, lse, lse, True, 32, 32, 2)}[entry]
    kw = {"group": 2, "bq": 32, "bk": 32} if entry == "flash_attention" \
        else {}
    fn = getattr(tfa, entry)
    k.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        fn(*args, **kw)
    with torch.no_grad():
        fn(*args, **kw)


# ------------------------------- the bf16 kernels' launches, mirrored ----

@pytest.mark.parametrize("kind", engine.FLASH_BWD_KINDS)
@pytest.mark.parametrize("d", range(8, 129, 8))
def test_flash_bwd_config_fits_shared_memory(d, kind):
    """engine.flash_bwd_config, the mirror of the bf16 launchers' own
    (chip_smoke.py holds the two equal on the card): the two fixed tiles
    and the ring's streamed tiles, head_dim held as two 64-column atoms,
    dK / dV's lse and delta rows and the mbarriers fit the card's 227 KB
    for every head_dim the kernels take; three warpgroups a CTA."""
    cfg = engine.flash_bwd_config(8, 200, d, 4, kind)
    assert cfg["smem"] <= engine.SMEM_LIMIT
    fixed, tile = ((cfg["kv_rows"], cfg["q_rows"]) if kind == "dkv"
                   else (cfg["q_rows"], cfg["kv_rows"]))
    assert cfg["smem"] >= 2 * engine.FLASH_HEAD_DIM * (
        2 * fixed + 2 * cfg["stages"] * tile)
    assert cfg["stages"] >= 2 and cfg["threads"] == 3 * 128
    # 200 rows: a full and a partial 128-row tile; dkv over 8 / 4 kv heads
    assert cfg["grid"] == ((2, 2) if kind == "dkv" else (8, 2))


@pytest.mark.parametrize("kind", engine.FLASH_BWD_KINDS)
@pytest.mark.parametrize("arch,bh", [("qwen2.5-14b", 80),
                                     ("phi3-mini-3.8b", 64)])
def test_flash_bwd_config_grid_at_the_lm_shapes(arch, bh, kind):
    """The grids at B 2 x S 2048 (Qwen2.5-14B's 40 / 8 heads of 128,
    phi3-mini-3.8b's 32 / 32 of 96): dK / dV one CTA a kv head and
    128-row kv tile, streaming 64-row q tiles; dQ one CTA a q head and
    128-row q tile, streaming 64-key kv tiles."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[arch]
    group = cfg.n_heads // cfg.n_kv_heads
    assert 2 * cfg.n_heads == bh
    launch = engine.flash_bwd_config(bh, 2048, cfg.resolved_head_dim, group,
                                     kind)
    if kind == "dkv":
        assert launch["grid"] == (bh // group, 2048 // 128)
        assert (launch["kv_rows"], launch["q_rows"]) == (128, 64)
    else:
        assert launch["grid"] == (bh, 2048 // 128)
        assert (launch["q_rows"], launch["kv_rows"]) == (128, 64)


def test_flash_bwd_config_follows_skv():
    """dK / dV's grid runs over Skv's kv tiles, dQ's over S's q tiles."""
    assert engine.flash_bwd_config(8, 200, 64, 2, "dkv", skv=384)["grid"] \
        == (4, 3)
    assert engine.flash_bwd_config(8, 200, 64, 2, "dq", skv=384)["grid"] \
        == (8, 2)


@pytest.mark.parametrize("d", [0, 12, 136])
def test_flash_bwd_config_refuses_a_head_dim(d):
    for kind in engine.FLASH_BWD_KINDS:
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            engine.flash_bwd_config(8, 128, d, 1, kind)


def test_flash_bwd_config_refuses_a_kind_and_a_group():
    with pytest.raises(ValueError, match="kind"):
        engine.flash_bwd_config(8, 128, 64, 1, "dqkv")
    with pytest.raises(ValueError, match="groups of 3"):
        engine.flash_bwd_config(8, 128, 64, 3, "dq")


# ----------------------------------------------- the kernels on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash backward kernels have no "
                    "CPU mode (python3 chip_smoke.py runs them)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(64, 32), (200, 96), (384, 128)])
def test_kernels_match_plain_on_card(cuda, causal, s, d):
    """bf16 within TOL_BF16 of max |plain|: S 64 and 200 leave the
    kernels' 128-row tiles partial, d 96 pads to 128 columns; two calls
    give the same bits (no atomics)."""
    q, k, v, do = (t.to(cuda) for t in _t(_case(60, 10, s, d, 5),
                                          torch.bfloat16))
    o, lse = tfa.flash_fwd(q, k, v, causal, s, s, 5)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, s, s, 5)
    got = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    again = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    want = (tfa.flash_bwd_dq_plain(*args), *tfa.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        w = w.float()
        assert float((g.float() - w).abs().max()) <= TOL_BF16 * float(
            w.abs().max())
