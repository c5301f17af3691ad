"""Minimal per-family launch fixtures for the port's kernel-contract passes.

The contract sweep only needs arguments that ASSEMBLE a launch (and, on
the card, run it with its protocol log): shapes obeying the family
contracts (ELL layout, gate widths, coef 0 on padding rows) at the sizes
of the JAX package's fixtures (``repro/analysis/cases.py``), which split
the state into two td-wide windows (H == 2 * TD) and the nodes into two
tiles of the TPU's TN. Kept independent of tests/harness.py on purpose:
the analyzer is a src/ subsystem and must not import the test tree (the
drift passes check that both build cases for every family). Every array
is seeded numpy, so findings are reproducible run to run; the argument
lists are ``ops.stream_steps``' (solo, no batch axis).
"""
from __future__ import annotations

import numpy as np

# the JAX fixtures' sizes: 2 node tiles (N / TN), 2 td-wide windows of H,
# odd T for both plane parities
N, K, T, TN, TD, H, DIN, DMID = 32, 4, 3, 16, 8, 16, 8, 12


def _ell_snapshots(rng, T=T, n=N, k=K, e=4 * N, din=DIN):
    """(idx, coef, eidx, x, renumber, mask): T padded ELL snapshots with
    ragged node counts, renumber rows into a store of 2 n + 9 rows, coef 0
    on padding rows."""
    G = 2 * n + 9
    arrs = {key: [] for key in ("idx", "coef", "eidx", "x", "ren", "mask")}
    for _ in range(T):
        nr = int(rng.integers(max(n // 3, 1), n + 1))
        idx = rng.integers(0, nr, (n, k)).astype(np.int32)
        coef = (rng.uniform(size=(n, k))
                * (rng.uniform(size=(n, k)) > 0.4)).astype(np.float32)
        coef[nr:] = 0.0
        x = rng.normal(size=(n, din)).astype(np.float32)
        x[nr:] = 0.0
        ren = np.full(n, -1, np.int32)
        ren[:nr] = rng.permutation(G)[:nr]
        mask = np.zeros(n, np.float32)
        mask[:nr] = 1.0
        eidx = rng.integers(0, e, (n, k)).astype(np.int32)
        for key, v in zip(("idx", "coef", "eidx", "x", "ren", "mask"),
                          (idx, coef, eidx, x, ren, mask)):
            arrs[key].append(v)
    return tuple(np.stack(arrs[key]) for key in
                 ("idx", "coef", "eidx", "x", "ren", "mask"))


def _rand(rng, shape, scale):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def stream_args(family: str, seed: int = 0):
    """The ``ops.stream_steps`` argument list of one family at fixture size
    (raises KeyError for a family without a fixture: the contract pass
    reports that as a finding)."""
    rng = np.random.default_rng(seed)
    G = 2 * N + 9
    if family == "gcrn":
        S = _ell_snapshots(rng)
        return (*S, _rand(rng, (G, H), 0.5), _rand(rng, (G, H), 0.5),
                _rand(rng, (DIN, 4 * H), 0.2), _rand(rng, (H, 4 * H), 0.2),
                _rand(rng, (4 * H,), 0.1))
    if family == "stacked":
        S = _ell_snapshots(rng)
        return (*S, _rand(rng, (G, H), 0.5), _rand(rng, (DIN, DMID), 0.2),
                _rand(rng, (DMID,), 0.1), _rand(rng, (DMID, 3 * H), 0.2),
                _rand(rng, (H, 3 * H), 0.2), _rand(rng, (3 * H,), 0.1))
    if family == "evolve":
        dims = [(DIN, H), (H, TD)]
        idx, coef, _eidx, x, _ren, mask = _ell_snapshots(rng)
        # a dead step between two live ones: the planes hold still there
        live = np.asarray([1, 0, 1], np.int32)
        ws = [_rand(rng, d, 0.3) for d in dims]
        bg = [_rand(rng, (d[1],), 0.1) for d in dims]
        gwx = [_rand(rng, (d[0], 3 * d[0]), 0.2) for d in dims]
        gwh = [_rand(rng, (d[0], 3 * d[0]), 0.2) for d in dims]
        gb = [_rand(rng, (3 * d[0],), 0.1) for d in dims]
        return (idx, coef, x, mask, live, ws, bg, gwx, gwh, gb)
    if family == "tgn":
        idx, coef, _eidx, x, ren, mask = _ell_snapshots(rng)
        ts = rng.uniform(0.0, 8.0, idx.shape).astype(np.float32)
        return (idx, coef, ts, x, ren, mask,
                _rand(rng, (G, H), 0.5),
                np.abs(_rand(rng, (H,), 0.5)) + 0.05,
                _rand(rng, (DIN, H), 0.2), _rand(rng, (H, 3 * H), 0.2),
                _rand(rng, (H, 3 * H), 0.2), _rand(rng, (3 * H,), 0.1))
    if family == "static_gcn":
        dims = [(DIN, H), (H, TD)]
        idx, coef, _eidx, x, _ren, mask = _ell_snapshots(rng, T=1)
        ws = [_rand(rng, d, 0.3) for d in dims]
        bs = [_rand(rng, (d[1],), 0.1) for d in dims]
        return (idx, coef, x, mask, ws, bs, None)
    raise KeyError(
        f"no contract-pass fixture for stream family {family!r}: a family "
        "was registered without analysis coverage — add a builder in "
        "repro_torch/analysis/cases.py")
