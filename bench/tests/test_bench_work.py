"""The work count against hand arithmetic, and its independence from
anything the port makes."""
import ast
import json

import numpy as np
import pytest

from conftest import ROOT
from bench.harness import core, streams

WIDTHS = {"in_dim": 64, "hidden": 128, "out_dim": 64, "edge_dim": 8,
          "n_gnn_layers": 2}


REPLAY = core.load_module(ROOT / "bench/drivers/replay.py", "driver",
                         "replay")


def work(name):
    return core.load_module(ROOT / "bench/work" / f"{name}.py", "work", name)


def three_nodes():
    # nodes 4, 7, 9; COO edges 4 -> 7 and 9 -> 7: 4 directed edges and
    # 3 self-loops, 7 ELL lanes
    snap = streams.Snapshot(np.array([4, 9]), np.array([7, 7]),
                            np.ones((2, 8), np.float32))
    return streams.Stream("s", "d", 10, np.zeros((10, 64), np.float32),
                          [snap])


def test_gcrn_count_by_hand():
    c = work("gcrn-m2").count(three_nodes(), WIDTHS)
    lanes, n, e = 7, 3, 2
    gates = 2 * 3 * (64 + 128) * 512
    agg = 2 * 7 * (64 + 128) + 2 * 2 * 64
    assert c["engine_flops"] == gates + agg
    assert c["step_flops"] == gates + agg + 2 * 4 * 8 * 64 + 2 * 3 * 128 * 64
    per_snap = (lanes * 12 + n * (64 * 4 + 8) + n * 128 * 16 + n * 128 * 4
                + 2 * e * 64 * 4)
    weights = (64 * 512 + 128 * 512 + 512) * 4
    assert c["engine_bytes"] == per_snap + weights


def test_evolve_count_by_hand():
    c = work("evolvegcn").count(three_nodes(), WIDTHS)
    lanes, n = 7, 3
    evolve = 12 * 128 * 64 * 64 + 12 * 64 * 128 * 128
    gcn = (2 * lanes * 64 + n * 64 + 2 * n * 64 * 128
           + 2 * lanes * 128 + n * 128 + 2 * n * 128 * 64)
    assert c["engine_flops"] == evolve + gcn
    assert c["step_flops"] == (evolve + gcn + 2 * lanes * 8
                               + 2 * n * 8 * (64 + 128) + evolve)
    per_snap = lanes * 8 + n * (64 * 4 + 4) + n * (64 + 128) * 4 + n * 64 * 4 + 4
    weights = 4 * ((2 * 64 * 128 + 128 + 2 * 64 * 192 + 192)
                   + (2 * 128 * 64 + 64 + 2 * 128 * 384 + 384))
    assert c["engine_bytes"] == per_snap + weights


@pytest.mark.parametrize("name", ["gcrn-m2", "evolvegcn"])
def test_count_reads_only_the_benchmarks_inputs(name):
    """The count imports numpy alone, and the port's ingest of the same
    stream, into any bucket, leaves it where it was."""
    tree = ast.parse((ROOT / "bench/work" / f"{name}.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= {"numpy", "__future__"}
    traffic = json.loads((ROOT / "bench/traffic/replay-b1.json").read_text())
    s = streams.generate_stream(traffic["pool"][0], 0, 99, 64, 8)
    s.snaps = s.snaps[:20]
    before = work(name).count(s, WIDTHS)
    for bucket in (traffic["bucket"],
                   {"n_pad": 1024, "e_pad": 8192, "k_max": 96}):
        REPLAY.ingest([s], bucket, "cpu")
        assert work(name).count(s, WIDTHS) == before
