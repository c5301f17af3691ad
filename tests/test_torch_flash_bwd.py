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
