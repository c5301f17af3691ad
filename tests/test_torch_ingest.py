"""The port's host-side ingest is the JAX package's, array for array.

``repro_torch.graph`` keeps its own numpy copies of ``repro.graph``'s
coo / csr / synthetic modules and its own ``PaddedSnapshot``; every array
they produce must equal the reference's exactly, on the paper's BC-Alpha
stream and on the harness's random ragged streams.
"""
import dataclasses

import numpy as np
import pytest
import torch

import harness
from repro import graph as jg
from repro.configs.dgnn import BC_ALPHA as J_BC_ALPHA
from repro_torch import graph as tg
from repro_torch.configs.dgnn import BC_ALPHA

FIELDS = [f.name for f in dataclasses.fields(tg.PaddedSnapshot)]


def _assert_padded_equal(port, ref):
    assert FIELDS == [f.name for f in dataclasses.fields(jg.PaddedSnapshot)]
    for name in FIELDS:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _bc_alpha(pkg, ds, T=8):
    graph, feat = pkg.generate_temporal_graph(ds, feat_dim=64)
    return graph, feat, pkg.slice_snapshots(graph, 1.0)[:T]


def test_configs_match_reference():
    from repro.configs import dgnn as jcfg
    from repro_torch.configs import dgnn as tcfg

    for name in ("EVOLVEGCN", "GCRN_M2", "BC_ALPHA", "UCI"):
        assert (dataclasses.asdict(getattr(tcfg, name))
                == dataclasses.asdict(getattr(jcfg, name))), name


def test_bc_alpha_generation_matches_reference():
    pg, pf, ps = _bc_alpha(tg, BC_ALPHA)
    rg, rf, rs = _bc_alpha(jg, J_BC_ALPHA)
    np.testing.assert_array_equal(pf, rf)
    for a, b in ((pg.src, rg.src), (pg.dst, rg.dst), (pg.time, rg.time),
                 (pg.edge_feat, rg.edge_feat)):
        np.testing.assert_array_equal(a, b)
    assert [s.n_edges for s in ps] == [s.n_edges for s in rs]


@pytest.mark.parametrize("source", ["bc_alpha", "random"])
def test_renumber_ell_pad_stack_match_reference(source):
    if source == "bc_alpha":
        _, feat, p_snaps = _bc_alpha(tg, BC_ALPHA)
        _, _, r_snaps = _bc_alpha(jg, J_BC_ALPHA)
    else:
        raw = harness.random_coo_stream(np.random.default_rng(5), T=6,
                                        n_pool=64, avg_edges=60, edge_dim=4)
        r_snaps = raw
        p_snaps = [tg.COOSnapshot(src=s.src, dst=s.dst, edge_feat=s.edge_feat,
                                  t_index=s.t_index) for s in raw]
        feat = np.random.default_rng(6).normal(size=(64, 16)).astype(np.float32)
    p_loc = [tg.renumber_and_normalize(s) for s in p_snaps]
    r_loc = [jg.renumber_and_normalize(s) for s in r_snaps]
    for a, b in zip(p_loc, r_loc):
        for name in ("src", "dst", "coef", "edge_feat", "renumber"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.n_nodes == b.n_nodes
    k_max = max(tg.max_in_degree(ls) for ls in p_loc)
    assert k_max == max(jg.max_in_degree(ls) for ls in r_loc)
    n_pad = max(ls.n_nodes for ls in p_loc)
    e_pad = max(ls.src.shape[0] for ls in p_loc)
    for a, b in zip(p_loc, r_loc):
        for x, y in zip(tg.to_ell(a, n_pad, k_max), jg.to_ell(b, n_pad, k_max)):
            np.testing.assert_array_equal(x, y)
    p_pad = [tg.pad_snapshot(ls, feat, n_pad, e_pad, k_max) for ls in p_loc]
    r_pad = [jg.pad_snapshot(ls, feat, n_pad, e_pad, k_max) for ls in r_loc]
    for a, b in zip(p_pad, r_pad):
        _assert_padded_equal(a, b)
    _assert_padded_equal(tg.stack_streams(p_pad), jg.stack_streams(r_pad))
    # the device copy carries the same values as tensors
    dev = tg.stack_streams(p_pad).to("cpu")
    assert all(torch.is_tensor(getattr(dev, n)) for n in FIELDS)
    _assert_padded_equal(dev, jg.stack_streams(r_pad))


def test_empty_padded_and_overflow_match_reference():
    _assert_padded_equal(tg.empty_padded(16, 32, 4, 8, 3),
                         jg.empty_padded(16, 32, 4, 8, 3))
    assert tg.round_up(13, 8) == jg.round_up(13, 8) == 16
    snap = tg.COOSnapshot(src=np.zeros(5, np.int64), dst=np.arange(1, 6),
                          edge_feat=np.zeros((5, 1), np.float32), t_index=0)
    ls = tg.renumber_and_normalize(snap)
    with pytest.raises(ValueError, match="in-degree overflow"):
        tg.to_ell(ls, 8, 2)
    with pytest.raises(ValueError, match="exceeds bucket"):
        tg.pad_snapshot(ls, np.zeros((6, 2), np.float32), 4, 64, 8)
