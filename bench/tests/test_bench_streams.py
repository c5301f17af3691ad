"""The stream generator: deterministic by seed, Table III's counts,
lengths, means and maxima, every seed the same sizes in another order."""
import json

import numpy as np
import pytest

from conftest import ROOT
from bench.harness import streams

TRAFFIC = json.loads((ROOT / "bench/traffic/replay-b16.json").read_text())
TABLE_III = {"bc-alpha": (107, 232, 578, 1686, 137),
             "uci": (118, 269, 501, 1534, 192)}


@pytest.fixture(scope="module")
def pool():
    return streams.generate_pool(TRAFFIC, 2 ** 31 + 5, 64, 8)


def test_pool_has_table_iii_counts_lengths_means_and_maxima(pool):
    assert [s.dataset for s in pool] == ["bc-alpha", "uci"] * 8
    for s in pool:
        avg_n, avg_e, max_n, max_e, T = TABLE_III[s.dataset]
        assert s.T == T and s.n_global == 6 * max_n
        n = np.array([streams.snapshot_dims(x)[0] for x in s.snaps])
        e = np.array([x.src.size for x in s.snaps])
        # every stream reaches the published maxima, in one snapshot
        assert n.max() == max_n and e.max() == max_e
        assert n[e.argmax()] == max_n
        # and averages the published means, to the rounding of T sizes
        assert abs(n.mean() - avg_n) < 0.5 and abs(e.mean() - avg_e) < 0.5
        assert all(not np.any(x.src == x.dst) for x in s.snaps)
        assert s.feat.shape == (s.n_global, 64) and s.feat.dtype == np.float32


@pytest.mark.parametrize("T,avg,top,low", [(137, 107, 578, 2),
                                           (192, 269, 1534, 1),
                                           (5, 16, 40, 2)])
def test_plan_sizes_mean_and_largest(T, avg, top, low):
    v = streams.plan_sizes(T, avg, top, low)
    assert v.size == T and np.all(np.diff(v) >= 0)
    assert v[-1] == top and v[0] >= low and abs(v.mean() - avg) < 0.5


@pytest.mark.parametrize("n,e", [(2, 1), (7, 4), (7, 30), (578, 1686)])
def test_snapshot_edges_touch_every_node(n, e):
    src, dst = streams.snapshot_edges(np.random.default_rng(n + e), n, e)
    assert src.size == dst.size == e and not np.any(src == dst)
    assert np.array_equal(np.unique(np.concatenate([src, dst])),
                          np.arange(n))


def test_pool_fits_the_bucket(pool):
    most = streams.check_fits(pool, TRAFFIC["bucket"])
    assert set(most) == {"bc-alpha", "uci"}
    for ds, (n, e, k) in most.items():
        # the largest snapshot: every node, both directions of every edge
        # and a self-loop a node, at Table III's maxima
        avg_n, avg_e, max_n, max_e, T = TABLE_III[ds]
        assert (n, e) == (max_n, 2 * max_e + max_n)
        assert k <= TRAFFIC["bucket"]["k_max"]
    with pytest.raises(ValueError, match="exceed the bucket"):
        streams.check_fits(pool, dict(TRAFFIC["bucket"], k_max=2))


def test_same_seed_same_pool_other_seed_same_sizes_other_graphs(pool):
    again = streams.generate_pool(TRAFFIC, 2 ** 31 + 5, 64, 8)
    other = streams.generate_pool(TRAFFIC, 7, 64, 8)
    for a, b, c in zip(pool, again, other):
        for x, y in zip(a.snaps, b.snaps):
            assert np.array_equal(x.src, y.src) and np.array_equal(x.ef, y.ef)
        assert np.array_equal(a.feat, b.feat)
        assert [x.src.size for x in a.snaps] != [x.src.size for x in c.snaps]
        assert (sorted(x.src.size for x in a.snaps)
                == sorted(x.src.size for x in c.snaps))
        assert not np.array_equal(a.feat, c.feat)


def test_snapshot_dims_by_hand():
    snap = streams.Snapshot(np.array([5, 5, 9]), np.array([9, 7, 7]),
                            np.zeros((3, 8), np.float32))
    # nodes 5, 7, 9; 6 directed edges and 3 self-loops; node 7 and node 9
    # each have in-degree 2 + 1
    assert streams.snapshot_dims(snap) == (3, 9, 3)
