"""The control: the plain reference computed in TF32, the precision below
the configurations' float32 with TF32 off, has to come out not correct
under each configuration's limits.

On the CPU the TF32 products are emulated (operands rounded to 10
mantissa bits, float32 accumulation) at the cells' widths over one
BC-Alpha-like and one UCI-like stream of 40 snapshots. The test marked
``cuda`` runs a whole cell on the card with the control beside the
program, as the limits were set: the program correct, the control not.
"""
import json

import pytest
import torch

from conftest import ROOT
from bench.harness import core, streams


@pytest.mark.parametrize("config", ["gcrn-m2", "evolvegcn"])
def test_tf32_control_fails_the_limits(config):
    cell = core.Cell.load(ROOT, f"{config}.replay-b16")
    w, bucket = cell.config["widths"], cell.traffic["bucket"]
    pool = [streams.generate_stream(ds, 0, seed, w["in_dim"], w["edge_dim"],
                                    seed)
            for seed, ds in enumerate(cell.traffic["pool"])]
    for s in pool:
        s.snaps = s.snaps[:40]
    G = max(s.n_global for s in pool)
    params = cell.reference.make_params(
        w, torch.Generator().manual_seed(3), "cpu")
    want = cell.reference.reference(params, pool, bucket["n_pad"], G, "cpu")
    low = cell.reference.reference(params, pool, bucket["n_pad"], G, "cpu",
                                   low=True)
    got = core.compare(*low, *want)
    limits = dict(cell.config["limits"], streams_unchecked=0.0)
    assert not core.within_limits(dict(got, streams_unchecked=0.0),
                                  limits), (got, limits)
    # the float32 reference against itself passes the same test
    same = core.compare(*want, *want)
    assert core.within_limits(dict(same, streams_unchecked=0.0), limits)


def test_within_limits_is_the_test_of_correct():
    limits = {"out_rel": 3e-5, "state_rel": 3e-5, "streams_unchecked": 0.0}
    assert core.within_limits({"out_rel": 3e-5, "state_rel": 0.0,
                               "streams_unchecked": 0.0}, limits)
    for bad in ({"out_rel": 3.1e-5}, {"state_rel": float("inf")},
                {"state_rel": float("nan")}, {"streams_unchecked": 1.0}):
        checks = dict({"out_rel": 0.0, "state_rel": 0.0,
                       "streams_unchecked": 0.0}, **bad)
        assert not core.within_limits(checks, limits), bad


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from bench.reference import _common

    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12,
                      -3.0 - 2 ** -12, 2.0 ** -126])
    assert _common.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                        -3.0, 2.0 ** -126]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    "gcrn-m2.replay-b16", "evolvegcn.replay-b16", "gcrn-m2.replay-b1",
    "evolvegcn.replay-b1", "gcrn-m2.serve-tenants"])
def test_on_the_card_program_correct_control_not(workload, small_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engines have no CPU mode")
    r = core.run(small_root, workload, 2 ** 31 + 101, 2.0, False,
                 out_dir=small_root / "out", control=True)
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    control = {k: c["value"] for k, c in r["control_checks"].items()}
    assert r["correct"], json.dumps(r["checks"])
    assert not core.within_limits(dict(control, streams_unchecked=0.0),
                                  limits), r["control_checks"]
