"""The port's flash attention computes the JAX package's flash kernels.

``repro_torch.kernels.flash_attention.flash_attention_plain`` and
``flash_fwd_plain`` (the CUDA kernel's plain versions, which its wrappers
run for CPU tensors) against the JAX package's ``flash_attention_pallas``
and ``_flash_fwd`` in interpret mode, on the same numpy inputs made from a
seed, at tests/test_kernels.py's shapes: o and the logsumexp within 2e-5
in fp32 (that test's tolerance), and one bf16 case within 1e-2 (bf16
inputs round both sides' p to bf16 before the p.v product; the two differ
only in fp32 summation order, which can move a bf16 output by one ulp,
7.8e-3 at |o| < 2). Distinct K / V per head with group > 1, so a wrong
q-head -> kv-head map fails. Both entry points refuse a tail (a tile that
does not divide the sequence), which the JAX ``_flash_fwd`` would leave
unwritten; ``flash_mha`` differentiates (its backward is held against the
JAX package's in tests/test_torch_flash_bwd.py); ``flops_bytes`` is the
JAX package's count; ``engine.flash_config``, the mirror of the bf16
kernel's launch, fits the card's shared memory at every head_dim.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import engine
from repro_torch.kernels import flash_attention as tfa


def _qkv(seed, bh, s, d, group, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return f32(bh, s, d), f32(bh // group, skv, d), f32(bh // group, skv, d)


def _t(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("s,bq,bk", [(128, 32, 32), (256, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_plain_matches_the_pallas_kernel(s, bq, bk, causal,
                                                         group):
    q, k, v = _qkv(0, 2 * 2 * group, s, 32, group)
    want = np.asarray(jfa.flash_attention_pallas(
        q, k, v, causal=causal, bq=bq, bk=bk, group=group, interpret=True))
    engine.reset_launches()
    got = tfa.flash_attention(*_t((q, k, v)), causal=causal, bq=bq, bk=bk,
                              group=group)
    assert not any(engine.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    plain = tfa.flash_attention_plain(*_t((q, k, v)), causal=causal, bq=bq,
                                      bk=bk, group=group)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("s,bq,bk", [(128, 32, 32), (256, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_fwd_plain_matches_the_pallas_kernel(s, bq, bk, causal, group):
    q, k, v = _qkv(1, 2 * 2 * group, s, 32, group)
    o_want, res = jfa._flash_fwd(q, k, v, causal, bq, bk, group, True)
    lse_want = np.asarray(res[4])
    engine.reset_launches()
    o, lse = tfa.flash_fwd(*_t((q, k, v)), causal, bq, bk, group)
    assert not any(engine.LAUNCHES.values())
    assert lse.dtype == torch.float32 and lse.shape == lse_want.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=2e-5, rtol=0)
    mha = tfa.flash_mha(*_t((q, k, v)), causal, bq, bk, group)
    np.testing.assert_array_equal(mha.numpy(), o.numpy())


def test_flash_fwd_plain_matches_the_pallas_kernel_in_bf16():
    q, k, v = _qkv(2, 10, 128, 32, 5)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    o_want, res = jfa._flash_fwd(qb, kb, vb, True, 32, 64, 5, True)
    o, lse = tfa.flash_fwd(*_t((q, k, v), torch.bfloat16), True, 32, 64, 5)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_want, np.float32), atol=1e-2,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), atol=2e-5,
                               rtol=0)


def test_gqa_reads_kv_head_bh_over_group():
    """Each q head attends its own kv head: q head h of group g reads kv
    head h // g; permuting the kv heads permutes the output blocks."""
    q, k, v = _qkv(3, 8, 64, 16, 4)
    o = tfa.flash_attention(*_t((q, k, v)), causal=True, bq=64, bk=64,
                            group=4)
    o_swapped = tfa.flash_attention(*_t((q, k[::-1].copy(), v[::-1].copy())),
                                    causal=True, bq=64, bk=64, group=4)
    assert not torch.allclose(o[:4], o_swapped[:4])
    for h in range(8):
        one = tfa.flash_attention(*_t((q[h:h + 1], k[h // 4:h // 4 + 1],
                                       v[h // 4:h // 4 + 1])),
                                  causal=True, bq=64, bk=64, group=1)
        np.testing.assert_allclose(o[h:h + 1].numpy(), one.numpy(),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("entry", ["flash_attention", "flash_fwd"])
def test_a_tail_is_refused(entry):
    """min(bq, S) must divide S (and min(bk, Skv) Skv): JAX's _flash_fwd
    leaves the tail rows unwritten, the port raises on both entry
    points."""
    q, k, v = _t(_qkv(4, 4, 96, 16, 2))
    fn = getattr(tfa, entry)
    with pytest.raises(ValueError, match="must divide"):
        fn(q, k, v, causal=True, bq=64, bk=32, group=2)
    with pytest.raises(ValueError, match="must divide"):
        fn(q, k, v, causal=True, bq=32, bk=64, group=2)
    fn(q, k, v, causal=True, bq=32, bk=32, group=2)  # divides: runs


@pytest.mark.parametrize("d,ok", [(16, True), (80, True), (96, True),
                                  (128, True), (136, False), (12, False)])
def test_head_dim_limit(d, ok):
    q, k, v = _t(_qkv(5, 2, 32, d, 1))
    if ok:
        assert tfa.flash_fwd(q, k, v, True, 32, 32, 1)[0].shape == q.shape
    else:
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            tfa.flash_fwd(q, k, v, True, 32, 32, 1)


def test_flash_mha_refuses_a_gradient():
    """No longer: flash_mha differentiates (flash_fwd, then flash_bwd).
    Its gradients are those of autograd through the plain forward, and
    under no_grad it runs as before."""
    q, k, v = _t(_qkv(6, 4, 32, 16, 2))
    q.requires_grad_(True)
    o = tfa.flash_mha(q, k, v, True, 32, 32, 2)
    assert o.grad_fn is not None
    do = torch.ones_like(o)
    (got,) = torch.autograd.grad(o, q, do)
    o_plain, _ = tfa.flash_fwd_plain(q, k, v, True, 32, 32, 2)
    (want,) = torch.autograd.grad(o_plain, q, do)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    with torch.no_grad():
        assert tfa.flash_mha(q, k, v, True, 32, 32, 2).shape == q.shape


@pytest.mark.parametrize("shape,kw", [
    ((1, 8, 8, 4096, 128), dict(causal=True)),
    ((2, 40, 8, 2048, 128), dict(causal=True, bq=512, bk=256)),
    ((1, 16, 16, 1024, 80), dict(causal=False, bq=128, bk=128)),
])
def test_flops_bytes_is_the_jax_count(shape, kw):
    assert tfa.flops_bytes(*shape, **kw) == jfa.flops_bytes(*shape, **kw)


# ----------------------------------- the bf16 kernel's launch, mirrored ----

@pytest.mark.parametrize("d", range(8, 129, 8))
def test_flash_config_fits_shared_memory(d):
    """engine.flash_config, the mirror of the bf16 launcher's own
    (chip_smoke.py holds the two equal on the card): the q tile and the
    ring's k / v tiles, head_dim held as two 64-column atoms, and the
    mbarriers fit the card's 227 KB for every head_dim the kernel takes;
    the grid is (q heads, q tiles)."""
    cfg = engine.flash_config(8, 200, d)
    assert cfg["smem"] <= engine.SMEM_LIMIT
    assert cfg["smem"] >= 2 * engine.FLASH_HEAD_DIM * (
        cfg["q_rows"] + 2 * cfg["stages"] * cfg["kv_rows"])
    assert cfg["stages"] >= 2 and cfg["threads"] == 3 * 128
    assert cfg["grid"] == (8, 2)  # 200 rows: a full and a partial q tile


@pytest.mark.parametrize("arch,bh", [("qwen2.5-14b", 80),
                                     ("phi3-mini-3.8b", 64)])
def test_flash_config_grid_at_the_lm_shapes(arch, bh):
    """The grid at the LM paths' shapes (B 2 x S 2048: Qwen2.5-14B's 40 q
    heads of 128, phi3-mini-3.8b's 32 of 96): one CTA a q head and
    128-row q tile."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[arch]
    assert 2 * cfg.n_heads == bh
    launch = engine.flash_config(bh, 2048, cfg.resolved_head_dim)
    assert launch["grid"] == (bh, 2048 // 128)
    assert launch["q_rows"] == launch["kv_rows"] == 128


@pytest.mark.parametrize("d", [0, 12, 136])
def test_flash_config_refuses_a_head_dim(d):
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        engine.flash_config(8, 128, d)


# ------------------------------------------------ the kernel on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode "
                    "(python3 chip_smoke.py runs it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,tile", [(384, 96, 128), (200, 128, 200),
                                      (200, 96, 512)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, causal, s, d, tile):
    """S 200 leaves the bf16 kernel's 128-row q tile and 128-key kv tile
    partial; d 96 pads to its 128 columns."""
    q, k, v = (t.to(cuda) for t in _t(_qkv(7, 10, s, d, 5), dtype))
    before = engine.LAUNCHES["flash_fwd"]
    o, lse = tfa.flash_fwd(q, k, v, causal, tile, tile, 5)
    assert engine.LAUNCHES["flash_fwd"] == before + 1
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, causal, tile, tile, 5)
    torch.cuda.synchronize()
    assert float((o.float() - o_p.float()).abs().max()) <= tol
    assert float((lse - lse_p).abs().max()) <= 1e-4
