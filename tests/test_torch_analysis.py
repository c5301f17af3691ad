"""repro_torch.analysis — the port's static checker: every rule fires on an
injected violation, the tree is clean, and the checker agrees with the JAX
package's (``repro.analysis``) where both read the same thing.

Injections, per pass group:
  * contract rules: a recorded launch doctored (a store cloned, a state
    given to the static engine), an estimate patched after recording, an
    assembly error raised, and synthetic protocol logs replayed;
  * lint rules: snippet files under tmp_path;
  * drift rules: drifted copies of docs/api.md, ci.yml and the harness.

The differential tests feed the same inputs to the JAX package's
pure-Python parts (its sweep points, lint, the ``_check_dma`` replay
through a stub launch, the drift parsers) and to the port's.
"""
import dataclasses
import json
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

import repro_torch.analysis as analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import cases, contracts, core, drift, lint
from repro_torch.analysis.contracts import Point
from repro_torch.kernels import engine, ops

ROOT = core.repo_root()
STATEFUL = ("evolve", "gcrn", "stacked", "tgn")
PAGED = {f: Point(f, "hbm_paged", 2, cases.TD) for f in STATEFUL}


def _rules(findings):
    return {f.rule for f in findings}


def _only(findings, rule):
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) >= 1 and _rules(findings) == {rule}, (
        rule, [f.message for f in findings])
    return hits[0]


def _record(point):
    (rec,) = contracts.record_point(point)
    return rec


# ==================================================== the clean tree ==

def test_clean_tree_zero_findings_and_byte_stable_json():
    first = analysis.run_all(device="cpu")
    assert first.findings == [] and first.suppressed == 0, first.to_text()
    assert set(first.rules_run) == set(analysis.ALL_RULES)
    again = analysis.run_all(device="cpu")
    assert first.to_json() == again.to_json()
    doc = json.loads(first.to_json())
    assert doc["counts"] == {"findings": 0, "suppressed": 0}
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            assert not core.suppressed_ids(line) or "``" in line, path


def test_the_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis.run_all()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])


def test_a_recorded_sweep_launches_and_counts_nothing():
    engine.reset_launches()
    findings = contracts.run_contracts(device="cpu")
    assert findings == []
    assert engine.LAUNCHES == {name: 0 for name in engine.KERNELS}


def test_a_recording_holds_for_its_own_thread_only():
    """Another thread's launches (the serve layer's device loop) run while
    a recording is on in this one."""
    args = cases.stream_args("gcrn")
    out = {}
    with engine.recording_launches() as recorded:
        t = threading.Thread(target=lambda: out.update(
            r=ops.stream_steps("gcrn", *args, device="cpu")))
        t.start()
        t.join(timeout=120)
    assert not t.is_alive() and recorded == []
    want = ops.stream_steps("gcrn", *args, device="cpu", force_ref=True)
    for got, ref in zip(out["r"], want):
        torch.testing.assert_close(got, ref, atol=3e-4, rtol=0)


@pytest.mark.parametrize("point", contracts.registry_points(),
                         ids=lambda p: p.label())
def test_every_point_records_its_own_kernel_unwritten(point):
    rec = _record(point)
    assert rec.name == point.kernel()
    assert rec.smem == engine.smem_bytes(rec.name,
                                         **contracts.launch_dims(rec))
    assert rec.dims == contracts.launch_dims(rec)
    assert rec.args.get("proto") is None
    if rec.name == "static_engine":
        assert rec.cluster is None and len(rec.result) == 1
    else:
        assert rec.cluster == engine.engine_cluster_config(
            rec.name, rec.ints["B"], **rec.dims)


# ================================================== contract rules ==

def test_launch_assembly_error_fires_on_a_raised_error(monkeypatch):
    def broken(*args, **kw):
        raise ValueError("injected refusal")

    monkeypatch.setattr(engine, "gcrn_engine_paged", broken)
    f = _only(contracts.run_contracts([PAGED["gcrn"]]),
              "launch-assembly-error")
    assert "ValueError: injected refusal" in f.message


def test_launch_assembly_error_fires_on_a_missing_fixture(monkeypatch):
    real = cases.stream_args

    def no_tgn(family, seed=0):
        if family == "tgn":
            return real("no-such-family")
        return real(family, seed)

    monkeypatch.setattr(cases, "stream_args", no_tgn)
    f = _only(contracts.run_contracts([PAGED["tgn"]]),
              "launch-assembly-error")
    assert "KeyError" in f.message


def test_launch_assembly_error_fires_without_a_launch(monkeypatch):
    real = ops.stream_steps
    monkeypatch.setattr(ops, "stream_steps",
                        lambda *a, **kw: real(*a, force_ref=True, **kw))
    f = _only(contracts.run_contracts([Point("stacked", "vmem", None, None)]),
              "launch-assembly-error")
    assert "no launch recorded" in f.message


def test_launch_assembly_error_fires_on_another_kernel(monkeypatch):
    monkeypatch.setitem(contracts.ENGINE, "gcrn", "stacked_engine")
    f = _only(contracts.run_contracts([Point("gcrn", "vmem", None, None)]),
              "launch-assembly-error")
    assert "expected stacked_engine" in f.message


@pytest.mark.parametrize("name", ["gcrn_engine_paged", "static_engine"])
def test_vmem_bytes_drift_fires_on_a_drifted_estimate(monkeypatch, name):
    family = "static_gcn" if name == "static_engine" else "gcrn"
    point = (Point(family, "vmem", None, None) if name == "static_engine"
             else PAGED[family])
    rec = _record(point)
    assert contracts.check_smem(point.label(), rec) == []
    args, fn = engine._SMEM[name]
    monkeypatch.setitem(engine._SMEM, name,
                        (args, lambda *a: fn(*a) + 16))
    f = _only(contracts.check_smem(point.label(), rec), "vmem-bytes-drift")
    assert f"+ 16" not in f.message and "budget-checked" in f.message


def test_vmem_bytes_drift_fires_on_a_drifted_cluster_launch():
    rec = _record(PAGED["stacked"])
    bad = dataclasses.replace(rec, cluster={**rec.cluster, "threads": 128})
    _only(contracts.check_smem("x", bad), "vmem-bytes-drift")


def test_vmem_bytes_drift_fires_on_a_wrong_widest_resident_evolve(
        monkeypatch):
    assert contracts.check_evolve_max_d(cases.K, 2) == []
    real = engine.evolve_resident_max_d
    monkeypatch.setattr(engine, "evolve_resident_max_d",
                        lambda k, L: real(k, L) + engine.ROW_ALIGN)
    _only(contracts.check_evolve_max_d(cases.K, 2), "vmem-bytes-drift")


@pytest.mark.parametrize("family", STATEFUL)
def test_hbm_alias_coverage_fires_on_a_cloned_store(family):
    rec = _record(PAGED[family])
    assert contracts.check_aliases("x", rec) == []
    cloned = dataclasses.replace(
        rec, result=(*rec.result[:-1], rec.result[-1].clone()))
    f = _only(contracts.check_aliases("x", cloned), "hbm-alias-coverage")
    assert "no view" in f.message or "a copy" in f.message


def test_hbm_alias_coverage_fires_on_a_store_it_does_not_return():
    rec = _record(Point("gcrn", "vmem", None, None))
    dropped = dataclasses.replace(rec, result=rec.result[:2])
    f = _only(contracts.check_aliases("x", dropped), "hbm-alias-coverage")
    assert "c_store" in f.message


def test_hbm_alias_coverage_holds_for_the_whole_sweep():
    for point in contracts.registry_points():
        rec = _record(point)
        if rec.name != "static_engine":
            assert contracts.check_aliases(point.label(), rec) == []
            for arg, i in engine.STORE_ARGS[rec.name.split("_")[0]].items():
                assert rec.args[arg] is rec.result[i]


def test_static_zero_states_fires_on_a_static_launch_given_a_state():
    point = Point("static_gcn", "vmem", None, cases.TD)
    rec = _record(point)
    assert contracts.check_static(point.label(), rec) == []
    h = torch.zeros(1, 4, 4)
    stated = dataclasses.replace(rec, args={**rec.args, "h_store": h},
                                 result=(*rec.result, h))
    f = _only(contracts.check_static(point.label(), stated),
              "static-zero-states")
    assert "h_store" in f.message


def test_static_zero_states_fires_on_a_non_static_contract(monkeypatch):
    rec = _record(Point("static_gcn", "vmem", None, None))
    monkeypatch.setitem(ops._TEMPORAL, "static_gcn", "dense")
    _only(contracts.check_static("x", rec), "static-zero-states")


# ------------------------------------------- the protocol log replay --

def _plain_log(point):
    return engine.protocol_of(_record(point))


@pytest.mark.parametrize("point", [p for p in contracts.registry_points()
                                   if p.family != "static_gcn"],
                         ids=lambda p: p.label())
def test_every_plain_log_replays_clean(point):
    log = _plain_log(point)
    assert contracts.replay(log, point.label()) == []
    paged = point.residency == "hbm_paged"
    rings = {int(r) for r in np.unique(log.rows[:, 1])} if len(log.rows) \
        else set()
    assert (engine.RING_STATE in rings) == paged
    assert (engine.RING_GRU in rings) == (point.family == "evolve")
    assert log.planes == ((1 if paged else 2) if point.family == "evolve"
                          else None)


def _ring_rows(log, cta=0, ring=engine.RING_STATE):
    keep = (log.rows[:, 0] == cta) & (log.rows[:, 1] == ring)
    return np.flatnonzero(keep)


def _edited(log, rows):
    return dataclasses.replace(log, rows=np.asarray(rows, np.int64))


@pytest.mark.parametrize("case, want", [
    ("reissue before wait", {"dma-ring-order", "dma-unpaired-start"}),
    ("out-of-order wait", {"dma-ring-order"}),
    ("missing window", {"dma-ring-order", "dma-unpaired-start"}),
    ("never waited", {"dma-ring-order", "dma-unpaired-start"}),
    ("wait without issue", {"dma-ring-order", "dma-unpaired-start"}),
    ("resident with rows", {"dma-missing-site"})])
def test_ring_rules_fire_on_synthetic_logs(case, want):
    """One ring's synthetic issue / wait stream (``DMA_STREAMS``): a slot
    reissued before its wait, waits out of order, a window never issued, an
    issue never waited, a wait with no issue, a resident launch with rows."""
    stream, depth, n_win = DMA_STREAMS[case]
    assert _port_dma(stream, depth, n_win) == want


def test_dma_ring_order_fires_on_a_missing_window():
    log = _plain_log(Point("stacked", "hbm_paged", 4, cases.TD))
    rows = log.rows
    last = log.sweeps[(0, engine.RING_STATE)]
    total = sum(last)
    # the last window of CTA 0's ring: neither issued nor waited
    drop = [i for i in _ring_rows(log) if rows[i, 2] == total - 1]
    f = _only(contracts.replay(_edited(log, np.delete(rows, drop, 0)), "x"),
              "dma-ring-order")
    assert "need" in f.message


def test_dma_unpaired_start_fires_on_an_issue_never_waited():
    log = _plain_log(PAGED["tgn"])
    rows = log.rows
    last_wait = [i for i in _ring_rows(log)
                 if rows[i, 6] == engine.EV_WAIT][-1]
    found = contracts.replay(_edited(log, np.delete(rows, [last_wait], 0)),
                             "x")
    # the window is issued and never waited; its waits no longer cover
    # the sweep either
    assert _rules(found) == {"dma-unpaired-start", "dma-ring-order"}
    assert any("never waited" in f.message for f in found)


def test_dma_unpaired_start_fires_on_a_wait_without_an_issue():
    log = _plain_log(Point("gcrn", "hbm_paged", 1, cases.TD))
    rows = log.rows
    first_issue = _ring_rows(log)[0]
    found = contracts.replay(_edited(log, np.delete(rows, [first_issue], 0)),
                             "x")
    assert "dma-unpaired-start" in _rules(found)


def test_dma_ring_order_fires_on_a_wrong_slot_or_parity():
    log = _plain_log(PAGED["evolve"])
    rows = log.rows.copy()
    i = _ring_rows(log, ring=engine.RING_GRU)[0]
    rows[i, 4] ^= 1
    f = _only(contracts.replay(_edited(log, rows), "x"), "dma-ring-order")
    assert "parity" in f.message


def test_dma_missing_site_fires_on_a_resident_launch_with_ring_rows():
    resident = _plain_log(Point("gcrn", "vmem", None, None))
    paged = _plain_log(PAGED["gcrn"])
    assert len(resident.rows) == 0
    f = _only(contracts.replay(_edited(resident, paged.rows), "x"),
              "dma-missing-site")
    assert "resident" in f.message


def test_dma_missing_site_fires_on_a_cta_that_never_issued():
    log = _plain_log(PAGED["stacked"])
    keep = log.rows[:, 0] != 3
    f = _only(contracts.replay(_edited(log, log.rows[keep]), "x"),
              "dma-missing-site")
    assert "CTA 3 never issued" in f.message


def test_dma_missing_site_fires_on_an_overflowed_log():
    log = _plain_log(PAGED["gcrn"])
    over = dataclasses.replace(log, overflow=True, count=len(log.rows) + 9)
    f = _only(contracts.replay(over, "x"), "dma-missing-site")
    assert "overflowed" in f.message


@pytest.mark.parametrize("paged", [False, True])
def test_pingpong_parity_fires_on_a_plane_off_by_one(paged):
    point = PAGED["evolve"] if paged else Point("evolve", "vmem", None, None)
    log = _plain_log(point)
    rows = log.rows.copy()
    reads = np.flatnonzero((rows[:, 1] == engine.RING_PLANE_READ)
                           & (rows[:, 6] == engine.EV_READ)
                           & (rows[:, 2] == 2))
    rows[reads, 3] = 1 - rows[reads, 3]
    f = _only(contracts.replay(_edited(log, rows), "x"), "pingpong-parity")
    assert "step 2 read plane" in f.message


def test_pingpong_parity_fires_on_a_stale_returned_plane():
    log = _plain_log(Point("evolve", "vmem", None, None))
    rows = log.rows.copy()
    finals = np.flatnonzero(rows[:, 6] == engine.EV_FINAL)
    rows[finals, 3] = 1 - rows[finals, 3]
    f = _only(contracts.replay(_edited(log, rows), "x"), "pingpong-parity")
    assert "returned" in f.message


def test_pingpong_parity_fires_on_a_write_on_a_dead_step():
    log = _plain_log(Point("evolve", "vmem", None, None))
    assert not log.live[0, 1]  # the fixture's dead step
    extra = np.asarray([[0, engine.RING_PLANE_WRITE, 1, 0, 0, 0,
                         engine.EV_WRITE]], np.int64)
    f = _only(contracts.replay(_edited(log, np.concatenate([log.rows, extra])),
                               "x"), "pingpong-parity")
    assert "dead" in f.message


def test_pingpong_parity_fires_on_planes_from_a_family_without_them():
    log = _plain_log(PAGED["gcrn"])
    extra = np.asarray([[0, engine.RING_PLANE_READ, 0, 0, 0, 0,
                         engine.EV_READ]], np.int64)
    _only(contracts.replay(_edited(log, np.concatenate([log.rows, extra])),
                           "x"), "pingpong-parity")


@pytest.mark.parametrize("name", engine.CLUSTER_ENGINES)
def test_cpu_wrapper_returns_the_plain_log_with_proto(name):
    """On CPU tensors ``proto=True`` returns the plain version's results and
    the launch's plain log, counting nothing."""
    family = name.split("_")[0]
    point = (PAGED[family] if name.endswith("_paged")
             else Point(family, "vmem", None, None))
    rec = _record(point)
    pos, kw = rec.call
    engine.reset_launches()
    got = getattr(engine, name)(*pos, **kw, proto=True)
    plain = getattr(engine, name)(*pos, **kw)
    assert not any(engine.LAUNCHES.values())
    log = got[-1]
    assert isinstance(log, engine.ProtoLog) and len(got) == len(plain) + 1
    for a, b in zip(got[:-1], plain):
        assert torch.equal(a, b)
    assert np.array_equal(log.rows, engine.protocol_of(rec).rows)
    assert contracts.replay(log, name) == []


def test_the_plain_log_walks_rows_past_one_chunk():
    """Past CHUNK_ROWS rows a step's tiles are walked in chunks: each chunk
    with live tiles is a sweep of its own."""
    n = engine.CHUNK_ROWS + 40
    mask = torch.zeros((1, 2, n))
    mask[0, 0, :5] = 1
    mask[0, 0, -3:] = 1
    mask[0, 1, 40:70] = 1
    log = engine.protocol_plain("stacked_engine_paged", mask, width=16,
                                td=8, depth=2)
    # H 16: 2 units a CTA, one 8-wide window a live tile
    assert log.sweeps[(0, engine.RING_STATE)] == (1, 1, 2)
    assert contracts.replay(log, "chunks") == []


# ===================================================== lint rules ==

LINT_SNIPPETS = {
    "stream-def-outside-registry": ("src/repro_torch/core/bad.py", """
        def gcrn_stream_fast(x):
            return x
    """),
    "mode-string-dispatch": ("src/repro_torch/serve/bad.py", """
        def go(run):
            return run(mode="v3")
    """),
    "direct-stream-steps": ("src/repro_torch/serve/bad.py", """
        from repro_torch.kernels import ops

        def go(*a):
            return ops.stream_steps("gcrn", *a)
    """),
    "broad-except": ("src/repro_torch/serve/bad.py", """
        def go(f):
            try:
                return f()
            except Exception:
                return None
    """),
    "mutable-default-arg": ("src/repro_torch/core/bad.py", """
        def go(x, acc=[]):
            acc.append(x)
            return acc
    """),
    "syntax-error": ("src/repro_torch/core/bad.py", """
        def go(:
    """),
}


def _write(root, rel, src):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return rel


@pytest.mark.parametrize("rule", sorted(LINT_SNIPPETS))
def test_lint_rule_fires(tmp_path, rule):
    rel, src = LINT_SNIPPETS[rule]
    _write(tmp_path, rel, src)
    found = lint.run_lint(tmp_path)
    assert _rules(found) == {rule}, [f.message for f in found]


def test_lint_scopes(tmp_path):
    """The registry module may name family stream defs, oracles ending in
    _ref may too, and the serve-only rules stay in the serve layer."""
    _write(tmp_path, "src/repro_torch/kernels/ops.py",
           "def gcrn_stream_fast(x):\n    return x\n")
    _write(tmp_path, "src/repro_torch/kernels/ref.py",
           "def gcrn_stream_ref(x):\n    return x\n")
    _write(tmp_path, "src/repro_torch/core/run.py",
           "def go(ops, *a):\n    return ops.stream_steps('gcrn', *a, "
           "mode='v3')\n")
    assert lint.run_lint(tmp_path) == []
    assert lint.LINT_ROOTS == ("src/repro_torch", "examples/torch")


def test_lint_suppression_is_counted(tmp_path):
    _write(tmp_path, "src/repro_torch/core/bad.py",
           "def go(x, acc=[]):  # booster: ignore[mutable-default-arg]\n"
           "    return acc\n")
    report = core.Report()
    kept = core.apply_suppressions(lint.run_lint(tmp_path), tmp_path, report)
    assert kept == [] and report.suppressed == 1


# ==================================================== drift rules ==

def test_plan_doc_drift_fires_on_a_drifted_table(tmp_path):
    text = (ROOT / "docs" / "api.md").read_text()
    drifted = "\n".join(
        line for line in text.splitlines()
        if not line.startswith("| `prefill_chunk`")).replace(
        "| `batch` |", "| `batch` / `gone_field` |")
    _write(tmp_path, "docs/api.md", drifted)
    found = drift.check_plan_docs(tmp_path)
    assert _rules(found) == {"plan-doc-drift"}
    msgs = " ".join(f.message for f in found)
    assert "`prefill_chunk` has no row" in msgs and "`gone_field`" in msgs


def test_family_levels_drift_fires():
    levels = {k: v for k, v in analysis.drift.api.FAMILY_LEVELS.items()
              if k != "tgn"}
    levels["mystery"] = ("v3",)
    found = drift.check_family_levels(levels=levels)
    assert _rules(found) == {"family-levels-drift"} and len(found) == 2


def test_ci_matrix_drift_fires(tmp_path):
    text = (ROOT / ".github" / "workflows" / "ci.yml").read_text()
    _write(tmp_path, ".github/workflows/ci.yml",
           text.replace("tgn, static_gcn]", "static_gcn]"))
    f = _only(drift.check_ci_matrix(tmp_path), "ci-matrix-drift")
    assert "tgn" in f.message
    _write(tmp_path, ".github/workflows/ci.yml", "on: push\n")
    _only(drift.check_ci_matrix(tmp_path), "ci-matrix-drift")


@pytest.mark.parametrize("which", ["harness_py", "cases_py"])
def test_harness_case_drift_fires(tmp_path, which):
    rel = {"harness_py": "tests/harness.py",
           "cases_py": "src/repro_torch/analysis/cases.py"}[which]
    text = (ROOT / rel).read_text().replace('family == "stacked"',
                                            'family == "stacked_old"')
    _write(tmp_path, rel, text)
    other = "cases_py" if which == "harness_py" else "harness_py"
    found = drift.check_harness_cases(
        tmp_path, **{which: rel, other: str(ROOT / {
            "harness_py": "tests/harness.py",
            "cases_py": "src/repro_torch/analysis/cases.py"}[other])})
    f = _only(found, "harness-case-drift")
    assert "stacked" in f.message


# =========================================================== the CLI ==

def test_cli_exit_codes(tmp_path, capsys):
    assert cli.main(["--device", "cpu"]) == 0
    assert "0 finding(s), 0 suppressed" in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "--format", "json",
                     "--rules", "contracts"]) == 0
    assert json.loads(capsys.readouterr().out)["counts"]["findings"] == 0
    rel, src = LINT_SNIPPETS["broad-except"]
    _write(tmp_path, rel, src)
    assert cli.main(["--device", "cpu", "--rules", "lint", "--root",
                     str(tmp_path), "--format", "github"]) == 1
    assert "::error file=src/repro_torch/serve/bad.py" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--rules", "no-such-rule"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "tpu"])
    assert e.value.code == 2
    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(rid in listed for rid in analysis.ALL_RULES)


def test_the_port_catalog_against_the_jax_catalog():
    """The port keeps the JAX rule ids where the meaning carries over and
    leaves out only the two rules that read Pallas kernel bodies."""
    from repro.analysis import ALL_RULES as JAX_RULES

    assert set(analysis.ALL_RULES) == set(JAX_RULES) - {
        "single-kernel-body", "jnp-in-kernel-body"}
    for rid, rule in analysis.ALL_RULES.items():
        assert rule.group == JAX_RULES[rid].group, rid


# ================================ differential against repro.analysis ==

def test_sweep_points_match_the_jax_registry_points():
    from repro.analysis import contracts as jax_contracts

    assert [p.label() for p in contracts.registry_points()] == [
        p.label() for p in jax_contracts.registry_points()]


@pytest.mark.parametrize("rule", sorted(LINT_SNIPPETS))
def test_lint_rules_fire_alike_in_both_packages(tmp_path, rule):
    """The same snippet fires the same rule id in the JAX lint and in the
    port's, each at a path in its own scope (the JAX serve-only rules read
    examples/, the port's its serve layer)."""
    from repro.analysis import lint as jax_lint

    rel, src = LINT_SNIPPETS[rule]
    port = _write(tmp_path / "port", rel, src)
    jax_rel = ("examples/bad.py" if rule in ("mode-string-dispatch",
                                             "direct-stream-steps")
               else "src/repro/core/bad.py")
    _write(tmp_path / "jax", jax_rel, src)
    got_port = lint.run_lint(tmp_path / "port", files=[port])
    got_jax = jax_lint.run_lint(tmp_path / "jax", files=[jax_rel])
    assert _rules(got_port) == _rules(got_jax) == {rule}


# start/wait streams over one ring: (event, window), depth, windows
DMA_STREAMS = {
    "clean d1": ([("s", 0), ("w", 0), ("s", 1), ("w", 1), ("s", 2),
                  ("w", 2)], 1, 3),
    "clean d2": ([("s", 0), ("s", 1), ("w", 0), ("s", 2), ("w", 1),
                  ("s", 3), ("w", 2), ("w", 3)], 2, 4),
    "clean d4": ([("s", 0), ("s", 1), ("s", 2), ("w", 0), ("w", 1),
                  ("w", 2)], 4, 3),
    "reissue before wait": ([("s", 0), ("s", 1), ("s", 2), ("w", 0),
                             ("w", 1), ("w", 2)], 2, 3),
    "out-of-order wait": ([("s", 0), ("s", 1), ("w", 1), ("w", 0),
                           ("s", 2), ("w", 2)], 2, 3),
    "missing window": ([("s", 0), ("s", 1), ("w", 0), ("s", 3), ("w", 1),
                        ("w", 3)], 2, 4),
    "never waited": ([("s", 0), ("s", 1), ("w", 0), ("s", 2), ("w", 1)],
                     2, 3),
    "wait without issue": ([("s", 0), ("w", 0), ("w", 1), ("s", 2),
                            ("w", 2)], 2, 3),
    "resident with rows": ([("s", 0), ("w", 0)], None, 1),
}


def _jax_dma(stream, depth, n_win):
    """The stream through the JAX ``_check_dma``: a stub paged launch with
    one row-kind state on ring 0 (its stage-in and write-back pairs added),
    or a resident one."""
    from repro.analysis import contracts as jax_contracts

    paged = depth is not None
    state = types.SimpleNamespace(kind="row", ring_idx=0)
    meta = types.SimpleNamespace(paged=paged, states=[state] if paged else [])
    launch = types.SimpleNamespace(meta=meta, grid=(1, 1, 1, n_win))
    d = depth or 1
    events = [{"event": "start" if e == "s" else "wait", "op": "ring",
               "state": 0, "slot": w % d, "window": w} for e, w in stream]
    if paged:
        events = ([{"event": ev, "op": "stage_in", "state": 0}
                   for ev in ("start", "wait")] + events
                  + [{"event": ev, "op": "write_back", "state": 0}
                     for ev in ("start", "wait")])
    point = jax_contracts.Point("gcrn", "hbm_paged" if paged else "vmem",
                                depth, 8)
    return _rules(jax_contracts._check_dma(point, launch, events))


def _port_dma(stream, depth, n_win):
    d = depth or 1
    rows = [(0, engine.RING_STATE, w, w % d, (w // d) & 1, w,
             engine.EV_ISSUE if e == "s" else engine.EV_WAIT)
            for e, w in stream]
    log = engine.ProtoLog(
        "gcrn_engine_paged" if depth else "gcrn_engine",
        np.asarray(rows, np.int64).reshape(-1, 7), len(rows), len(rows),
        False, {engine.RING_STATE: depth} if depth else {},
        {(0, engine.RING_STATE): (n_win,)} if depth else {}, None, None, 1,
        1, 1)
    return _rules(contracts.replay(log, "stream"))


@pytest.mark.parametrize("case", sorted(DMA_STREAMS))
def test_dma_replay_agrees_with_the_jax_check_dma(case):
    stream, depth, n_win = DMA_STREAMS[case]
    want = _jax_dma(stream, depth, n_win)
    assert _port_dma(stream, depth, n_win) == want
    assert (want == set()) == case.startswith("clean")


def test_drift_parsers_agree_with_the_jax_ones():
    import ast

    from repro.analysis import drift as jax_drift

    text = (ROOT / "docs" / "api.md").read_text()
    assert drift.parse_plan_table(text) == jax_drift.parse_plan_table(text)
    assert drift.PLAN_TABLE_HEADING == jax_drift.PLAN_TABLE_HEADING
    tree = ast.parse((ROOT / "tests" / "harness.py").read_text())
    got = drift._case_families(tree, "stream_kernel_case")
    assert got == jax_drift._case_families(tree, "stream_kernel_case")
    assert got[0] == set(ops.stream_families())
