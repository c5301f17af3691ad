"""The drivers, on the port's plain CPU path at a small size.

``replay``: a traffic file that names no driver gets it, and its calls
are the ones the harness made before the drivers were files of their own:
``BoosterSession.run_batched`` over a group, or ``reset_state`` then
``BoosterSession.run`` over one stream, with their labels and, bit for
bit, their outputs and states.

``serve``: the pool in one global id space, one ``serve_multi`` call of 4
tenants' raw COO histories under the continuous scheduler, correct
against the plain reference, and the reference computed in TF32 in the
program's place not correct (the control).
"""
import numpy as np
import pytest
import torch

from bench.harness import core, streams


@pytest.mark.parametrize("traffic", ["small-b4", "small-b1"])
def test_replay_driver_makes_the_calls_it_made_in_the_harness(small_root,
                                                              traffic):
    cell = core.Cell.load(small_root, f"gcrn-m2.{traffic}")
    assert "driver" not in cell.traffic
    assert cell.driver.__name__ == "bench_driver_replay"
    w, bucket = cell.config["widths"], cell.traffic["bucket"]
    pool = streams.generate_pool(cell.traffic, 6, w["in_dim"], w["edge_dim"])
    G = max(s.n_global for s in pool)
    params = cell.reference.make_params(
        w, torch.Generator().manual_seed(6), "cpu")
    padded = cell.driver.ingest(pool, bucket, "cpu")
    session = cell.driver.make_session(cell, params, G, "cpu", padded)
    groups = core.call_groups(cell.traffic, len(pool))
    calls = [cell.driver.make_call(session, padded, g,
                                   cell.reference.port_state)
             for g in groups]
    per_call = cell.traffic["streams_per_call"]
    assert [label for _, label in calls] == [
        "session.run" if per_call == 1 else "session.run_batched"] * len(
        groups)
    for (fn, _), g in zip(calls, groups):
        outs, states = fn()
        if per_call == 1:
            session.reset_state()
            want_outs = [session.run(padded[g[0]])]
            want_states = [cell.reference.port_state(session.state)]
        else:
            st, want_outs = session.run_batched([padded[j] for j in g])
            want_states = [cell.reference.port_state(st, b)
                           for b in range(len(g))]
        for a, b in zip(outs, want_outs, strict=True):
            assert torch.equal(a, b)
        for a, b in zip(states, want_states, strict=True):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_serve_pool_is_one_id_space_over_one_table(small_root):
    cell = core.Cell.load(small_root, "gcrn-m2.small-serve")
    w = cell.config["widths"]
    base = streams.generate_pool(cell.traffic, 8, w["in_dim"], w["edge_dim"])
    pool = cell.driver.make_pool(cell.traffic, 8, w["in_dim"], w["edge_dim"])
    total = sum(s.n_global for s in base)
    off = 0
    for s, b in zip(pool, base, strict=True):
        assert s.n_global == total and s.feat.shape[0] == total
        assert np.array_equal(s.feat[off:off + b.n_global], b.feat)
        for x, y in zip(s.snaps, b.snaps, strict=True):
            assert np.array_equal(x.src, y.src + off)
            assert np.array_equal(x.dst, y.dst + off)
            assert np.array_equal(x.ef, y.ef)
            assert off <= min(x.src.min(), x.dst.min())
            assert max(x.src.max(), x.dst.max()) < off + b.n_global
        off += b.n_global


def test_serve_cell_is_correct_and_its_control_is_not(small_root):
    r = core.run(small_root, "gcrn-m2.small-serve", 2 ** 31 + 9, 0.3, False,
                 device="cpu", control=True)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert checks["streams_unchecked"] == 0.0
    control = {k: c["value"] for k, c in r["control_checks"].items()}
    assert not core.within_limits(dict(control, streams_unchecked=0.0),
                                  limits), control


def test_serve_call_returns_every_snapshot_padding_rows_zero(small_root):
    cell = core.Cell.load(small_root, "gcrn-m2.small-serve")
    w, bucket = cell.config["widths"], cell.traffic["bucket"]
    pool = cell.driver.make_pool(cell.traffic, 10, w["in_dim"],
                                 w["edge_dim"])
    params = cell.reference.make_params(
        w, torch.Generator().manual_seed(10), "cpu")
    inputs = cell.driver.ingest(pool, bucket, "cpu")
    session = cell.driver.make_session(cell, params, pool[0].n_global, "cpu",
                                       inputs)
    assert session.plan.scheduler == "continuous"
    fn, label = cell.driver.make_call(session, inputs, [0, 1, 2, 3],
                                      cell.reference.port_state)
    assert label == "session.serve_multi"
    outs, states = cell.driver.layout(*fn(), "cpu")
    for o, s in zip(outs, pool, strict=True):
        assert o.shape == (s.T, bucket["n_pad"], w["out_dim"])
        for t, x in enumerate(s.snaps):
            n = streams.snapshot_dims(x)[0]
            assert not o[t, n:].any()
    assert len(states) == 4
