"""The static GCN engine's launch and the widths the main path hands it.

* ``engine.static_plan``: a cluster of 8 CTAs a slot, each owning a column
  slice of every layer's output at the layer's true width, shared memory
  that does not grow with n or k and takes every (k, D) the one-CTA kernel
  took; past STATIC_MAX_LAYERS layers every width is D.
* ``ops._static_launch`` hands the wrapper the true widths of the unpadded
  weights; the wrapper refuses widths that are not L + 1 in [1, D].
* On a card (skipped here): the kernel against its plain version on the
  cases chip_smoke.py runs (the pack's widths, D 13, three layers, square,
  the widest D, n past 65,536 rows), bit for bit across two calls, its
  launch equal to the library's own plan.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops


def test_static_plan_at_the_main_shape():
    """BC-Alpha's 137 static slots (k 27, D 128; layers 64 -> 128 -> 64): a
    cluster of 8 CTAs of 256 threads a slot, CTA r owning columns
    [16 r, 16 r + 16) of layer 0's output and [8 r, 8 r + 8) of layer 1's."""
    plan = engine.static_plan(137, 27, 128, [64, 128, 64])
    assert (plan["cluster"], plan["ctas"], plan["threads"]) == (8, 1096, 256)
    assert plan["slices"][0] == [(16 * r, 16 * r + 16) for r in range(8)]
    assert plan["slices"][1] == [(8 * r, 8 * r + 8) for r in range(8)]
    assert plan["widths"] == [64, 128, 64]
    # two tiles a pass: two (64, 128 + 4) buffers, the partial sums of a
    # product pass for each tile (2 x 8 x 32 x 16), the live-tile bits, the
    # bias slice (16) and the W slice (128 x 16)
    assert plan["weights_smem"] and plan["pass_rows"] == 64
    assert plan["smem"] == 4 * (2 * 64 * 132 + 2 * 8 * 32 * 16 + 64 + 16
                                + 128 * 16)


@pytest.mark.parametrize("widths", [[13, 11, 7], [64, 128, 64], [5, 3],
                                    [32, 64, 40, 24]])
def test_static_plan_slices_cover_each_layer(widths):
    plan = engine.static_plan(3, 5, max(widths), widths)
    assert len(plan["slices"]) == len(widths) - 1
    for dout, slices in zip(widths[1:], plan["slices"]):
        assert len(slices) == engine.CLUSTER
        owned = [c for lo, hi in slices for c in range(lo, hi)]
        assert owned == list(range(dout))


def test_static_plan_past_max_layers_runs_the_square_width():
    widths = [4] * (engine.STATIC_MAX_LAYERS + 2)
    plan = engine.static_plan(1, 1, 16, widths)
    assert plan["widths"] == [16] * len(widths)
    assert engine.static_plan(1, 1, 16, widths[1:])["widths"] == widths[1:]


@pytest.mark.parametrize("k", [1, 5, 27, 40, 300])
def test_static_smem_does_not_grow_with_k_and_takes_every_d(k):
    """Shared memory depends on D alone, and every D the one-CTA kernel
    took at this k (two k-major (D, 36) tiles and the ELL lanes) fits."""
    one_cta = lambda D: 4 * 2 * D * engine.TILE_STRIDE \
        + engine.TILE_ROWS * k * 8
    widest = max(D for D in range(1, 2000)
                 if one_cta(D) <= engine.SMEM_LIMIT)
    for D in (1, 8, 13, 64, 128, 256, 257, 384, 385, widest):
        assert engine.smem_bytes("static_engine", k=k, D=D) == \
            engine.smem_bytes("static_engine", k=1, D=D)
        assert engine.smem_bytes("static_engine", k=k, D=D) <= \
            engine.SMEM_LIMIT, D


def test_static_variant_by_width():
    """Two tiles a pass with the W slice in shared memory up to D 256, two
    tiles a pass with W read from L2 up to D 384, one tile a pass past it."""
    assert engine.static_weights_in_smem(256)
    assert not engine.static_weights_in_smem(257)
    assert engine.static_pass_rows(384) == 64
    assert engine.static_pass_rows(385) == 32
    assert [engine.static_plan(1, 5, D, [D, D])["pass_rows"]
            for D in (16, 256, 257, 384, 385, 806)] == [64] * 4 + [32] * 2


@pytest.mark.parametrize("dims", [[(13, 11), (11, 7)],
                                  [(5, 9), (9, 9), (9, 3)]])
def test_static_launch_hands_the_wrapper_the_true_widths(monkeypatch, dims):
    rng = np.random.default_rng(3)
    B, n, k = 2, 37, 5
    widths = [dims[0][0]] + [d[1] for d in dims]
    f32 = lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.3).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (B, 1, n, k)).astype(np.int32))
    coef = f32(B, 1, n, k)
    mask = torch.ones(B, 1, n)
    seen = {}
    wrapper = engine.static_engine

    def spy(*args, **kwargs):
        seen.update(kwargs, D=args[4].shape[-1])
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(engine, "static_engine", spy)
    (outs,) = tops._static_launch(True, idx, coef,
                                  f32(B, 1, n, widths[0]), mask,
                                  [f32(*d) for d in dims],
                                  [f32(d[1]) for d in dims])
    assert seen["widths"] == widths
    align = engine.ROW_ALIGN
    assert seen["D"] == -(-max(widths) // align) * align
    assert outs.shape == (B, 1, n, widths[-1])


@pytest.mark.parametrize("widths", [[13, 11], [13, 11, 17], [0, 11, 7]])
def test_static_wrapper_refuses_bad_widths(widths):
    B, n, k, L, D = 1, 8, 2, 2, 16
    args = (torch.zeros(B, 1, n, k, dtype=torch.int32),
            torch.zeros(B, 1, n, k), torch.zeros(B, 1, n, D),
            torch.zeros(B, 1, n), torch.zeros(L, D, D), torch.zeros(L, D))
    with pytest.raises(ValueError, match="widths"):
        engine.static_engine(*args, widths=widths)


# ------------------------------------------------------------ the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (python3 chip_smoke.py runs them)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, B, n, k, D, widths, edges):
    """Packed static_engine inputs: slot 0 half padding, slot 1 dead, x / W
    / b / eagg zero past each layer's widths (as the square pack leaves
    them)."""
    rng = np.random.default_rng(seed)
    L = len(widths) - 1
    rows = np.ones((B, n), bool)
    rows[0, n // 2:] = False
    rows[1] = False
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    idx = rng.integers(0, max(n // 2, 1), (B, 1, n, k)).astype(np.int32)
    coef = (rng.uniform(0.1, 1.0, (B, 1, n, k))
            * (rng.uniform(size=(B, 1, n, k)) < 0.6)
            * rows[:, None, :, None]).astype(np.float32)
    x = np.zeros((B, 1, n, D), np.float32)
    x[..., :widths[0]] = f32(B, 1, n, widths[0])
    w = np.zeros((L, D, D), np.float32)
    bg = np.zeros((L, D), np.float32)
    for l in range(L):
        w[l, :widths[l], :widths[l + 1]] = f32(widths[l], widths[l + 1])
        bg[l, :widths[l + 1]] = f32(widths[l + 1])
    eagg = None
    if edges:
        eagg = np.zeros((B, 1, L, n, D), np.float32)
        for l in range(L):
            eagg[:, :, l, :, :widths[l]] = f32(B, 1, n, widths[l])
    return [None if a is None else torch.from_numpy(a) for a in
            (idx, coef, x, rows[:, None].astype(np.float32), w, bg, eagg)]


STATIC_CARD_CASES = [(3, 37, 5, 16, [13, 11, 7], True),
                     (3, 640, 27, 128, [64, 128, 64], True),
                     (2, 70, 33, 13, [13, 9, 5], False),
                     (3, 100, 1, 64, [32, 64, 40, 24], True),
                     (2, 37, 40, 96, None, False),
                     (3, 130, 5, 256, [256, 256], True),
                     (3, 130, 5, 384, [384, 384], True),
                     (3, 100, 1, 806, None, False),
                     (2, 66_000, 27, 64, [64, 64, 32], True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STATIC_CARD_CASES)
def test_static_engine_matches_plain_on_card(cuda, case):
    B, n, k, D, widths, edges = case
    wd = widths if widths is not None else [D, D, D]
    inp = [None if a is None else a.to(cuda)
           for a in _case(5, B, n, k, D, wd, edges)]
    got = engine.static_engine(*inp, widths=widths)
    again = engine.static_engine(*inp, widths=widths)
    want = engine.static_plain(*inp)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two calls differ"
    assert not got[..., wd[-1]:].any()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4)
    lib = engine.library_static_plan(B, k, D)
    mine = engine.static_plan(B, k, D, wd)
    assert lib == {key: mine[key] for key in lib}
