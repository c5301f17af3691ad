"""The plain references against the port's plain CPU path at a small
size: the same parameters and inputs, the port's ingest on one side and
the reference's own graph on the other."""

import pytest
import torch

from conftest import ROOT, small_copy
from bench.harness import core, streams


@pytest.mark.parametrize("config", ["gcrn-m2", "evolvegcn"])
def test_reference_equals_the_port_on_cpu(tmp_path, config):
    root = small_copy(tmp_path)
    cell = core.Cell.load(root, f"{config}.small-b4")
    w, bucket = cell.config["widths"], cell.traffic["bucket"]
    pool = streams.generate_pool(cell.traffic, 5, w["in_dim"], w["edge_dim"])
    # ragged: one stream cut short
    pool[1].snaps = pool[1].snaps[:3]
    G = max(s.n_global for s in pool)
    params = cell.reference.make_params(
        w, torch.Generator().manual_seed(5), "cpu")
    padded = cell.driver.ingest(pool, bucket, "cpu")
    session = cell.driver.make_session(cell, params, G, "cpu", padded)
    states, outs = session.run_batched(padded)
    got_s = [cell.reference.port_state(states, b) for b in range(len(pool))]
    session.reset_state()
    one = session.run(padded[0])
    ref_outs, ref_states = cell.reference.reference(
        params, pool, bucket["n_pad"], G, "cpu")
    checks = core.compare(outs, got_s, ref_outs, ref_states)
    assert checks["out_rel"] < 1e-5 and checks["state_rel"] < 1e-5
    assert torch.allclose(one, ref_outs[0], atol=1e-5)
    assert core.compare([one], [cell.reference.port_state(session.state)],
                        ref_outs[:1], ref_states[:1])["state_rel"] < 1e-5
    # the reference in TF32 is further away than the program
    low = core.compare(*cell.reference.reference(
        params, pool, bucket["n_pad"], G, "cpu", low=True),
        ref_outs, ref_states)
    assert low["out_rel"] > 10 * checks["out_rel"]


def test_reference_imports_nothing_of_the_port():
    import ast

    for path in sorted((ROOT / "bench/reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        assert mods <= {"math", "numpy", "torch", "__future__",
                        "dataclasses", "bench.reference"}, path
