"""The check catches a broken timed path. Each run drives the rest of a
run on the port's plain CPU path (no card), with the engine broken
underneath, and ``correct`` must come out false: for a step that returns
its state unchanged, for half of the batch left out, and for an answer
altered where it is produced. The exchange between chips does not exist
in these cells (one card, streams independent)."""
import pytest

from bench.harness import core
from repro_torch.kernels import engine


def state_unchanged(family, res, packed):
    if family == "gcrn":
        return res[0], packed[6].clone(), packed[7].clone()
    return res[0], packed[5].clone()


def half_left_out(family, res, packed):
    outs = res[0].clone()
    B = outs.shape[0]
    if B > 1:
        outs[B // 2:] = 0
        state = [s.clone() for s in res[1:]]
        for s, s0 in zip(state, packed[6:8] if family == "gcrn"
                         else packed[5:6]):
            s[B // 2:] = s0[B // 2:]
        return (outs, *state)
    # one stream: the second half of each snapshot's live rows
    mask = packed[5] if family == "gcrn" else packed[3]
    outs[mask.cumsum(-1) > mask.sum(-1, keepdim=True) / 2] = 0
    return (outs, *res[1:])


def altered(family, res, packed):
    # the first step of the first stream is live in every launch; the last
    # may be a dead tail (the serve engine pads a chunk's T to a power of 2)
    outs = res[0].clone()
    outs[0, 0, 0, 0] += 1.0
    return (outs, *res[1:])


@pytest.mark.parametrize("fault", [None, state_unchanged, half_left_out,
                                   altered])
@pytest.mark.parametrize("cell", ["gcrn-m2.small-b4", "gcrn-m2.small-b1",
                                  "evolvegcn.small-b4", "evolvegcn.small-b1",
                                  "gcrn-m2.small-serve"])
def test_a_broken_engine_is_not_correct(small_root, monkeypatch, cell, fault):
    family = "gcrn" if cell.startswith("gcrn") else "evolve"
    name = f"{family}_engine"
    real = getattr(engine, name)

    def broken(*packed, **kw):
        res = real(*packed, **kw)
        return fault(family, res, packed)

    if fault is not None:
        monkeypatch.setattr(engine, name, broken)
    r = core.run(small_root, cell, 11, 0.5, False, device="cpu")
    assert r["correct"] is (fault is None), r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_calls_that_raise_are_counted_and_not_correct(small_root, monkeypatch):
    real, launches = engine.gcrn_engine, []

    def fails(*packed, **kw):
        launches.append(1)
        if len(launches) > 1:  # the warm-up call passes, the window's fail
            raise RuntimeError("launch failed")
        return real(*packed, **kw)

    monkeypatch.setattr(engine, "gcrn_engine", fails)
    r = core.run(small_root, "gcrn-m2.small-b4", 2, 0.1, False, device="cpu")
    assert r["correct"] is False and r["failed"] == r["attempted"] > 0
    assert r["checks"]["streams_unchecked"]["value"] == 4
