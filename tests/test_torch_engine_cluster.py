"""The cluster stream engines (``gcrn_engine``, ``evolve_engine``,
``stacked_engine``, ``tgn_engine`` and their paged variants), held on the
CPU.

Each runs one stream on a thread-block cluster of ``engine.CLUSTER`` CTAs;
CTA r owns the columns [r W / C, (r + 1) W / C) of a W-wide state (GCRN's,
the stacked engine's and TGN's hidden units, with GCRN's and the stacked
engine's input columns; EvolveGCN's columns of every W_l). This file
holds:

  1. the launch mirror (``engine.engine_cluster_config``): every unit and
     column owned by exactly one CTA, at widths C does and does not divide;
  2. a CTA's shared memory (``engine.smem_bytes``) within the card's at the
     main path's widths, resident and paged at every ring depth, and at
     the widest plans the one-CTA stacked / TGN kernels took; where a
     stacked / TGN CTA's weights leave shared memory; no paged CTA that
     grows with n, and no n refused; the compiler's report (read by
     ``chip_smoke.py``'s 0-spill check) kept beside a cached library;
  3. a plain-torch model of the column-sliced step, written here: each
     slice aggregated on its own, the aggregate tile all-gathered, each
     slice's product and update on the whole tile. It equals the kernels'
     plain versions (``engine.<family>_plain``) within 1e-6 and the JAX
     package's oracle (``stream_steps[_batched](..., force_ref=True)`` on
     ``harness.stream_kernel_case``) within 3e-4;
  4. the kernels against their plain versions on the card (marked ``cuda``:
     they skip without one; ``python3 chip_smoke.py`` runs them).
"""
import numpy as np
import pytest
import torch

import harness
from repro.kernels import ops as jops
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as _ref

ATOL_JAX = 3e-4
ATOL_PLAIN = 1e-6
# the main path's widths (configs/dgnn.py at BC-Alpha: n_pad 640, k_max 27;
# EvolveGCN-O's two layers share the square width 128)
MAIN = {"gcrn_engine": dict(k=27, din=64, H=128, n=640),
        "evolve_engine": dict(k=27, L=2, D=128),
        "stacked_engine": dict(k=27, din=64, dmid=128, H=128),
        "tgn_engine": dict(k=22, din=64, H=128)}
#: rows of a step past one chunk of a CTA's live-tile bits
ROWS_PAST = 70_000


def _flat(res):
    out = []
    for r in res:
        out.extend(_flat(r) if isinstance(r, (tuple, list)) else [r])
    return [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in out]


def _close(got, want, atol, label):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{label}[{i}]")


# ----------------------------------------------------- launch mirror ----

def _dims(name, width):
    paged = name.endswith("paged")
    if name.startswith("gcrn"):
        dims = dict(k=5, din=13, H=width, n=40)
    elif name.startswith("stacked"):
        dims = dict(k=5, din=13, dmid=24, H=width)
    elif name.startswith("tgn"):
        dims = dict(k=5, din=13, H=width, **(dict(n=40) if paged else {}))
    else:
        dims = dict(k=5, D=width) if paged else dict(k=5, L=2, D=width)
    return dict(dims, td=8, depth=2) if paged else dims


@pytest.mark.parametrize("name,width", [
    (name, w) for name in ("gcrn_engine", "gcrn_engine_paged",
                           "stacked_engine", "stacked_engine_paged",
                           "tgn_engine", "tgn_engine_paged")
    for w in (20, 128)] + [
    (name, w) for name in ("evolve_engine", "evolve_engine_paged")
    for w in (8, 24, 128, 256)])
def test_cluster_config_owns_each_column_once(name, width):
    """The slices tile the state's columns in order, one a CTA; a B-stream
    launch is B clusters of engine.CLUSTER CTAs."""
    cfg = engine.engine_cluster_config(name, 3, **_dims(name, width))
    assert cfg["cluster"] == engine.CLUSTER and cfg["ctas"] == 3 * engine.CLUSTER
    assert cfg["smem"] == engine.smem_bytes(name, **_dims(name, width))
    gru = engine.GRU_THREADS if name == "evolve_engine" else 0
    assert cfg["threads"] == engine.CLUSTER_THREADS + gru
    assert ("weights_smem" in cfg) == name.startswith(("stacked", "tgn"))
    for key, total in (("slices", width),) + (
            (("x_slices", 13),) if name.startswith(("gcrn", "stacked"))
            else ()):
        slices = cfg[key]
        assert len(slices) == engine.CLUSTER
        owned = [c for lo, hi in slices for c in range(lo, hi)]
        assert owned == list(range(total)), (key, slices)
        widths = [hi - lo for lo, hi in slices]
        assert max(widths) - min(widths) <= 1, (key, widths)


def test_cluster_config_names_only_cluster_engines():
    with pytest.raises(ValueError, match="not a cluster engine"):
        engine.engine_cluster_config("static_engine", 1, k=5, D=8)


@pytest.mark.parametrize("name,depth", [
    (f"{family}_engine", None) for family in ("gcrn", "evolve", "stacked",
                                              "tgn")] + [
    (f"{family}_engine_paged", d)
    for family in ("gcrn", "evolve", "stacked", "tgn")
    for d in engine.RING_DEPTHS])
def test_cluster_cta_fits_the_card_at_the_main_widths(name, depth):
    dims = dict(MAIN[name.removesuffix("_paged")])
    if depth is not None:
        if name.startswith("evolve"):
            dims.pop("L")
        if name.startswith("tgn"):
            dims["n"] = 640
        dims.update(td=16, depth=depth)
    assert 0 < engine.smem_bytes(name, **dims) <= engine.SMEM_LIMIT
    if name.startswith(("stacked", "tgn")):  # the main path's weights fit
        assert engine.engine_cluster_config(name, 1, **dims)["weights_smem"]


# the widest plans the one-CTA stacked / TGN kernels took (their estimate
# within SMEM_LIMIT), resident, and paged TGN where the one-CTA kernel
# refused (its slot held all n gathered rows)
WIDEST = [("stacked_engine", dict(k=27, din=64, dmid=736, H=736)),
          ("stacked_engine", dict(k=27, din=64, dmid=128, H=1348)),
          ("tgn_engine", dict(k=22, din=64, H=496)),
          ("tgn_engine", dict(k=27, din=64, H=492)),
          ("tgn_engine_paged", dict(k=22, din=64, H=128, n=700, td=16,
                                    depth=4)),
          ("tgn_engine_paged", dict(k=22, din=64, H=128, n=1400, td=16,
                                    depth=2))]


@pytest.mark.parametrize("name,dims", WIDEST)
def test_widest_plans_of_the_one_cta_kernels_still_fit(name, dims):
    assert engine.smem_bytes(name, **dims) <= engine.SMEM_LIMIT
    assert engine.engine_cluster_config(name, 1, **dims)["smem"] == \
        engine.smem_bytes(name, **dims)


@pytest.mark.parametrize("name,dims,room", [
    ("stacked_engine", dict(k=27, din=64, dmid=128), 208),
    ("tgn_engine", dict(k=22, din=64), 180)])
def test_weights_leave_shared_memory_past_their_room(name, dims, room):
    """Up to H ``room`` a CTA holds its own weights in shared memory; past
    it they stay in global memory (L2): the flag turns off and the CTA's
    bytes drop by the weights', within the card, where the weights would
    not have fit."""
    flag = (engine.stacked_weights_in_smem if name.startswith("stacked")
            else engine.tgn_weights_in_smem)
    step = 8 if name.startswith("stacked") else 4
    assert flag(H=room, **dims) and not flag(H=room + step, **dims)
    on = engine.smem_bytes(name, H=room, **dims)
    off = engine.smem_bytes(name, H=room + step, **dims)
    assert off < on <= engine.SMEM_LIMIT
    assert not flag(H=2 * room, **dims)
    assert engine.smem_bytes(name, H=2 * room, **dims) <= engine.SMEM_LIMIT


@pytest.mark.parametrize("name,dims", [
    ("tgn_engine_paged", dict(k=22, din=64, H=128, td=16, depth=4)),
    ("stacked_engine_paged", dict(k=27, din=64, dmid=128, H=128, td=16,
                                  depth=4)),
    ("gcrn_engine_paged", dict(k=27, din=64, H=128, td=16, depth=4))])
def test_no_paged_cta_grows_with_n(name, dims):
    """A paged window holds at most BOX_ROWS gathered rows (the stacked CTA
    only a tile's own 32: it takes no n), and a step's live tiles are
    walked in chunks of CHUNK_ROWS rows, so a CTA's bytes are the same at
    n 640 and n 65,537."""
    sizes = {engine.smem_bytes(name, n=n, **dims) for n in (640, 65_537)}
    assert len(sizes) == 1 and sizes.pop() <= engine.SMEM_LIMIT


def _wide_gcrn(n, H=128, din=64, k=27, B=1, T=2, seed=3):
    """Packed gcrn_engine inputs at the main path's widths and n rows (CPU
    tensors, numpy from seed)."""
    rng = np.random.default_rng(seed)
    G = 2 * n + 9
    f = lambda *sh: torch.from_numpy((rng.normal(size=sh) * 0.3)
                                     .astype(np.float32))
    rows = torch.from_numpy(np.stack([[rng.permutation(G)[:n]
                                       for _ in range(T)] for _ in range(B)])
                            .astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, n, (B, T, n, k)).astype(np.int32))
    coef = f(B, T, n, k) * torch.from_numpy(rng.random((B, T, n, k)) > 0.3)
    return (idx, coef, torch.zeros_like(idx), f(B, T, n, din), rows,
            torch.ones(B, T, n), f(B, G, H), f(B, G, H), f(din, 4 * H),
            f(H, 4 * H), f(4 * H))


def test_resident_gcrn_rows_leave_shared_memory_past_its_room():
    """The resident GCRN CTA keeps the step's gathered rows in shared
    memory up to n 911 at the main path's widths, and past that in global
    scratch: its shared memory stops growing with n, so no n is refused
    for it (past one chunk of live-tile bits too)."""
    dims = dict(k=27, din=64, H=128)
    fits = [n for n in (640, 911, 912, 4096, ROWS_PAST)
            if engine.gcrn_rows_in_smem(n=n, **dims)]
    assert fits == [640, 911]
    past = {engine.smem_bytes("gcrn_engine", n=n, **dims)
            for n in (912, 4096, ROWS_PAST)}
    assert len(past) == 1 and past.pop() <= engine.SMEM_LIMIT
    assert engine.smem_bytes("gcrn_engine", n=911, **dims) <= engine.SMEM_LIMIT
    cfg = engine.engine_cluster_config("gcrn_engine", 1, n=4096, **dims)
    assert cfg["smem"] == engine.smem_bytes("gcrn_engine", n=4096, **dims)


def test_resident_gcrn_past_its_room_runs_plain_on_the_cpu():
    """At n 1000 (rows past the CTA's shared memory) the CPU entry point
    runs the plain version, as at every n, and refuses nothing."""
    args = _wide_gcrn(1000)
    _close(engine.gcrn_engine(*args), engine.gcrn_plain(*args), 0.0,
           "gcrn_engine n=1000 on the cpu")


def test_resident_evolve_refusal_names_its_widest_d():
    """Past its room the resident EvolveGCN refuses with the JAX hint to
    page, followed by the widest D that fits at the call's k and L."""
    k, L, D, n = 5, 2, 256, 8
    widest = engine.evolve_resident_max_d(k, L)
    assert widest % engine.ROW_ALIGN == 0
    assert engine.smem_bytes("evolve_engine", k=k, L=L, D=widest) \
        <= engine.SMEM_LIMIT < engine.smem_bytes("evolve_engine", k=k, L=L,
                                                 D=widest + engine.ROW_ALIGN)
    assert widest < D
    z = torch.zeros
    args = (z(1, 1, n, k, dtype=torch.int32), z(1, 1, n, k), z(1, 1, n, D),
            z(1, 1, n), torch.ones(1, 1, dtype=torch.int32), z(1, L, D, D),
            z(L, D), z(L, D, 3 * D), z(L, D, 3 * D), z(L, 3 * D))
    with pytest.raises(ValueError, match=r"page the state store .* fits up "
                       rf"to D {widest}\)$"):
        engine.evolve_engine(*args)


def _rows_past_case(family, n=ROWS_PAST, k=3, T=2, seed=5):
    """Packed inputs of the family's resident kernel at n rows a step
    (narrow widths; CPU tensors, numpy from seed): real rows and partners
    under the event contract, distinct global rows."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy((rng.normal(size=sh) * 0.3)
                                     .astype(np.float32))
    H, din, G = 8, 4, n + 9
    nr = n - 100
    rows = np.arange(n) < nr
    mask = torch.from_numpy(np.broadcast_to(rows, (1, T, n))
                            .astype(np.float32).copy())
    idx = rng.integers(0, nr, (1, T, n, k)).astype(np.int32)
    coef = torch.from_numpy((rng.random((1, T, n, k)) * rows[:, None])
                            .astype(np.float32))
    rowg = np.stack([[np.where(rows, rng.permutation(G)[:n], G)
                      for _ in range(T)]]).astype(np.int32)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    x = f(1, T, n, din if family != "evolve" else H) * mask[..., None]
    if family == "gcrn":
        return (i32(idx), coef, torch.zeros_like(i32(idx)), x, i32(rowg),
                mask, f(1, G, H), f(1, G, H), f(din, 4 * H), f(H, 4 * H),
                f(4 * H))
    if family == "stacked":
        return (i32(idx), coef, torch.zeros_like(i32(idx)), x, i32(rowg),
                mask, f(1, G, H), f(din, 8), f(8), f(8, 3 * H),
                f(H, 3 * H), f(3 * H))
    if family == "tgn":
        gidx = np.take_along_axis(rowg, idx.reshape(1, T, -1), axis=-1)
        return (i32(gidx.reshape(idx.shape)), coef,
                f(1, T, n, k).abs() * 10, x, i32(rowg), mask, f(1, G, H),
                f(H).abs(), f(din, H), f(H, 3 * H), f(H, 3 * H), f(3 * H))
    return (i32(idx), coef, x, mask, torch.ones(1, T, dtype=torch.int32),
            f(1, 2, H, H), f(2, H), f(2, H, 3 * H), f(2, H, 3 * H),
            f(2, 3 * H))


def _tgn_local(args):
    """TGN's paged inputs: partners by local id, from the global rows."""
    gidx, rowg = args[0], args[4]
    lid = torch.empty_like(gidx)
    for t in range(gidx.shape[1]):
        inv = torch.zeros(int(rowg.max()) + 2, dtype=torch.int64,
                          device=rowg.device)
        inv[rowg[0, t].long()] = torch.arange(rowg.shape[2],
                                              device=rowg.device)
        lid[0, t] = inv[gidx[0, t].long()].to(torch.int32)
    return (lid, *args[1:])


def test_build_keeps_the_ptxas_log_beside_a_cached_library(tmp_path,
                                                           monkeypatch):
    """chip_smoke's 0-spill check reads ptxas's report from
    ``engine.BUILD_LOG``: a library built by an earlier process reports it
    too (kept beside it), and a library without its log is built again.
    Here a stand-in compiler writes the library and a report."""
    runs = tmp_path / "runs"
    report = ("ptxas info    : Function properties for stacked_engine_kernel\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads\n")
    (tmp_path / "report").write_text(report)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {runs}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
        f"cat {tmp_path / 'report'}\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(engine, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(engine, "BUILD_LOG", {})
    lib = engine.build(("stacked_engine",))["stacked_engine"]
    assert engine.BUILD_LOG["stacked_engine"] == report
    assert lib.with_suffix(".log").read_text() == report
    engine.BUILD_LOG.clear()  # a later process: the library is cached
    assert engine.build(("stacked_engine",))["stacked_engine"] == lib
    assert engine.BUILD_LOG["stacked_engine"] == report
    assert runs.read_text().count("run") == 1
    lib.with_suffix(".log").unlink()  # no log: built again
    engine.build(("stacked_engine",))
    assert runs.read_text().count("run") == 2
    assert lib.with_suffix(".log").read_text() == report


@pytest.mark.parametrize("family", ["gcrn", "evolve", "stacked", "tgn"])
def test_cpu_entry_points_take_any_n(family):
    """No cluster engine refuses a step past one chunk of live-tile bits
    (n 70,000): on the CPU both residencies run their plain versions."""
    args = _rows_past_case(family)
    res = getattr(engine, f"{family}_engine")(*args)
    pag = getattr(engine, f"{family}_engine_paged")(
        *(_tgn_local(args) if family == "tgn" else args), td=8, depth=2)
    _close(res, getattr(engine, f"{family}_plain")(*args), 0.0,
           f"{family} n={ROWS_PAST} resident")
    _close(pag, res, 1e-5, f"{family} n={ROWS_PAST} paged")


# ------------------------------------- the column-sliced step, plain ----

def _slices(width):
    b = engine.slice_bounds(width)
    return [slice(lo, hi) for lo, hi in zip(b[:-1], b[1:])]


def sliced_gcrn(idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b,
                emsg=None):
    """The GCRN step as the cluster runs it, on gcrn_plain's packed inputs:
    each CTA gathers its units' t-1 rows, aggregates its input columns and
    its units' h columns, the cluster all-gathers [agg_x | agg_h], and each
    CTA runs its units' gates and LSTM update."""
    G, H = h0.shape[1:]
    ren = torch.where(rowg < G, rowg, -1)
    h_st, c_st = h0.clone(), c0.clone()
    units, xcols = _slices(H), _slices(x.shape[-1])
    outs = []
    for t in range(idx.shape[1]):
        r, m = ren[:, t], mask[:, t]
        lanes = (idx[:, t], coef[:, t], eidx[:, t])
        em = None if emsg is None else emsg[:, t]
        h_rows = [_ref._gather_rows(h_st[..., u], r, m) for u in units]
        c_rows = [_ref._gather_rows(c_st[..., u], r, m) for u in units]
        agg_x = torch.cat([_ref.ell_spmm(*lanes, x[:, t][..., s],
                                         None if em is None else em[..., s])
                           for s in xcols], dim=-1)
        agg_h = torch.cat([_ref.ell_spmm(*lanes, hq) for hq in h_rows],
                          dim=-1)
        h_new, c_new = [], []
        for u, cq in zip(units, c_rows):
            cols = torch.cat([torch.arange(H)[u] + g * H for g in range(4)])
            gates = agg_x @ wx[:, cols] + agg_h @ wh[:, cols] + b[cols]
            i, f, g, o = gates.chunk(4, dim=-1)
            cn = (torch.sigmoid(f) * cq + torch.sigmoid(i) * torch.tanh(g)) \
                * m[..., None]
            h_new.append(torch.sigmoid(o) * torch.tanh(cn) * m[..., None])
            c_new.append(cn)
        h_new, c_new = torch.cat(h_new, dim=-1), torch.cat(c_new, dim=-1)
        _ref._scatter_rows_(h_st, r, h_new)
        _ref._scatter_rows_(c_st, r, c_new)
        outs.append(h_new)
    return torch.stack(outs, dim=1), h_st, c_st


def sliced_evolve(idx, coef, x, mask, live, w0, bg, gwx, gwh, gb, eagg=None):
    """The EvolveGCN step as the cluster runs it, on evolve_plain's packed
    inputs: each CTA aggregates its own columns of a_l, the cluster
    all-gathers the aggregate, each CTA multiplies it by its columns of W_l,
    and on a live step evolves exactly its columns (the GRU's batch)."""
    T, L, D = idx.shape[1], w0.shape[1], w0.shape[2]
    cols = _slices(D)
    w = w0.clone()
    outs = []
    for t in range(T):
        a = x[:, t]
        m = mask[:, t][..., None]
        for l in range(L):
            parts = []
            for s in cols:
                part = (_ref._take_rows(a[..., s], idx[:, t])
                        * coef[:, t][..., None]).sum(dim=-2)
                if eagg is not None:
                    part = part + eagg[:, t, l][..., s]
                parts.append(part)
            agg = torch.cat(parts, dim=-1)
            h = torch.cat([agg @ w[:, l, :, s] + bg[l, s] for s in cols],
                          dim=-1)
            a = (torch.relu(h) if l < L - 1 else h) * m
        outs.append(a)
        on = (live[:, t] > 0)[:, None, None]
        for l in range(L):
            new = torch.cat([
                _ref.fused_gru(w[:, l, :, s].transpose(1, 2),
                               w[:, l, :, s].transpose(1, 2), gwx[l], gwh[l],
                               gb[l]).transpose(1, 2) for s in cols], dim=-1)
            w[:, l] = torch.where(on, new, w[:, l])
    return torch.stack(outs, dim=1), w


def _gru_slices(x, h, wx, wh, b, units):
    """The GRU as the cluster runs it: each slice of units on the whole x
    and h (the all-gathered tile), its r | z | n columns of wx, wh, b."""
    H = h.shape[-1]
    out = []
    for u in units:
        cols = torch.cat([torch.arange(H)[u] + g * H for g in range(3)])
        rx, zx, nx = (x @ wx[:, cols] + b[cols]).chunk(3, dim=-1)
        rh, zh, nh = (h @ wh[:, cols]).chunk(3, dim=-1)
        r, z = torch.sigmoid(rx + rh), torch.sigmoid(zx + zh)
        out.append((1.0 - z) * torch.tanh(nx + r * nh) + z * h[..., u])
    return torch.cat(out, dim=-1)


def sliced_stacked(idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b,
                   emsg=None):
    """The stacked step as the cluster runs it, on stacked_plain's packed
    inputs: each CTA reads its units' t-1 h rows and aggregates its input
    columns, the cluster all-gathers [agg | h], each CTA computes its
    columns of nt on the whole agg, the cluster all-gathers nt, and each
    CTA runs its units' GRU."""
    G, H = h0.shape[1:]
    ren = torch.where(rowg < G, rowg, -1)
    h_st = h0.clone()
    units, xcols = _slices(H), _slices(x.shape[-1])
    mcols = _slices(wg.shape[-1])
    outs = []
    for t in range(idx.shape[1]):
        r, m = ren[:, t], mask[:, t]
        lanes = (idx[:, t], coef[:, t], eidx[:, t])
        em = None if emsg is None else emsg[:, t]
        h_rows = torch.cat([_ref._gather_rows(h_st[..., u], r, m)
                            for u in units], dim=-1)
        agg = torch.cat([_ref.ell_spmm(*lanes, x[:, t][..., s],
                                       None if em is None else em[..., s])
                         for s in xcols], dim=-1)
        nt = torch.cat([agg @ wg[:, s] + bg[s] for s in mcols], dim=-1)
        h_new = _gru_slices(nt, h_rows, wx, wh, b, units) * m[..., None]
        _ref._scatter_rows_(h_st, r, h_new)
        outs.append(h_new)
    return torch.stack(outs, dim=1), h_st


def sliced_tgn(gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b):
    """The TGN step as the cluster runs it, on tgn_plain's packed inputs:
    each CTA computes its columns of inp (x @ its W_in columns, its
    columns of the partners' memory, its frequencies of the time encoding)
    and reads its columns of the own rows, the cluster all-gathers
    [inp | own], and each CTA runs its units' GRU; the new rows are
    scattered after the batch's tiles."""
    G, H = mem0.shape[1:]
    store = mem0.clone()
    units = _slices(H)
    outs = []
    for t in range(gidx.shape[1]):
        ren = torch.where(rowg[:, t] < G, rowg[:, t], -1)
        m, c = mask[:, t], coef[:, t][..., None]
        inp, own = [], []
        for u in units:
            part = (_ref._take_rows(store[..., u], gidx[:, t]) * c).sum(-2)
            enc = (torch.cos(ts[:, t][..., None] * freq[u]) * c).sum(-2)
            inp.append(x[:, t] @ w_in[:, u] + part + enc)
            own.append(_ref._gather_rows(store[..., u], ren, m))
        m_new = _gru_slices(torch.cat(inp, dim=-1), torch.cat(own, dim=-1),
                            wx, wh, b, units) * m[..., None]
        _ref._scatter_rows_(store, ren, m_new)
        outs.append(m_new)
    return torch.stack(outs, dim=1), store


SLICED = {"gcrn": sliced_gcrn, "evolve": sliced_evolve,
          "stacked": sliced_stacked, "tgn": sliced_tgn}


@pytest.mark.parametrize("family", sorted(SLICED))
@pytest.mark.parametrize("lengths", [None, (4, 2, 0)])
def test_sliced_step_matches_plain_and_jax(family, lengths):
    args, _, _ = harness.stream_kernel_case(family, seed=13, T=4, B=3)
    targs = tops.to_device(tuple(args), "cpu")
    packed = tops.pack(family, *targs, lengths=lengths)
    got = SLICED[family](*packed)
    _close(got, getattr(engine, f"{family}_plain")(*packed), ATOL_PLAIN,
           f"{family} sliced vs plain")
    want = jops.stream_steps_batched(family, *args, tn=32, lengths=lengths,
                                     force_ref=True)
    if family == "evolve":  # unpack the common square width
        dims = [wl.shape[-2:] for wl in targs[5]]
        outs, wT = got
        got = (outs[..., :dims[-1][1]],
               [wT[:, i, :di, :do] for i, (di, do) in enumerate(dims)])
    _close(got, want, ATOL_JAX, f"{family} sliced vs jax")


# ---------------------------------------------- kernels on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cluster engines have no CPU "
                    "mode (python3 chip_smoke.py runs them)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(SLICED))
@pytest.mark.parametrize("paged", [False, True])
def test_cluster_kernel_matches_plain_on_card(cuda, family, paged):
    args, _, _ = harness.stream_kernel_case(family, seed=17, T=4, B=3)
    args = tops.to_device(tuple(args), cuda)
    packed = tops.pack(family, *args, lengths=(4, 2, 0))
    name = f"{family}_engine" + ("_paged" if paged else "")
    ring = dict(td=8, depth=2) if paged else {}
    before = engine.LAUNCHES[name]
    got = getattr(engine, name)(*(tops.pack(
        family, *args, lengths=(4, 2, 0), residency="hbm_paged")
        if paged else packed), **ring)
    torch.cuda.synchronize()
    assert engine.LAUNCHES[name] == before + 1
    _close(got, getattr(engine, f"{family}_plain")(*packed), 1e-4,
           f"{name} vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(SLICED))
def test_cluster_kernels_past_one_chunk_of_rows_on_card(cuda, family):
    """n ROWS_PAST (two chunks of live-tile bits): resident and paged
    within 1e-4 of the plain version, bit for bit equal to each other."""
    args = [t.to(cuda) if torch.is_tensor(t) else t
            for t in _rows_past_case(family)]
    paged_args = _tgn_local(args) if family == "tgn" else args
    res = getattr(engine, f"{family}_engine")(*args)
    pag = getattr(engine, f"{family}_engine_paged")(*paged_args, td=8,
                                                    depth=2)
    torch.cuda.synchronize()
    _close(res, getattr(engine, f"{family}_plain")(*args), 1e-4,
           f"{family} n={ROWS_PAST} vs plain")
    _close(pag, res, 0.0, f"{family} n={ROWS_PAST} paged vs resident")


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_wide_gcrn_past_the_rows_room_on_card(cuda, paged):
    """n 1000 at the main path's widths: the resident CTA's rows in global
    scratch, within 1e-4 of the plain version and bit for bit equal to the
    paged kernel."""
    args = tuple(t.to(cuda) for t in _wide_gcrn(1000))
    got = engine.gcrn_engine_paged(*args, td=16, depth=2) if paged else \
        engine.gcrn_engine(*args)
    torch.cuda.synchronize()
    _close(got, engine.gcrn_plain(*args), 1e-4, "gcrn n=1000 vs plain")
    if paged:
        _close(got, engine.gcrn_engine(*args), 0.0, "paged vs resident")
