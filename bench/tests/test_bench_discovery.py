"""A configuration, a traffic mix, a driver and a metric added as files of
their own are found by name, with no edit to the harness."""
import json
import shutil
import sys

from bench.harness import core


def test_new_config_traffic_and_metric_need_no_code(small_root):
    b = small_root / "bench"
    for kind, ext in (("reference", "py"), ("work", "py"), ("configs", "json")):
        shutil.copy(b / kind / f"gcrn-m2.{ext}", b / kind / f"gcrn-copy.{ext}")
    t = json.loads((b / "traffic/small-b4.json").read_text())
    t["streams_per_call"] = 2
    (b / "traffic/small-b2.json").write_text(json.dumps(t))
    (b / "metrics/calls_completed.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    (b / "metrics/silent.py").write_text("def read(ctx):\n    return None\n")
    man = json.loads((small_root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="gcrn-copy",
                               file="bench/configs/gcrn-copy.json"))
    man["workloads"].append({"name": "gcrn-copy.small-b2",
                             "config": "gcrn-copy", "traffic": "small-b2",
                             "chips": 1, "why": "added as files"})
    for name in ("calls_completed", "silent"):
        man["end_to_end"].append({"name": name, "unit": "calls",
                                  "better": "higher", "bound": 0.01,
                                  "source": "host_clock",
                                  "workloads": ["gcrn-copy.small-b2"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(man))
    r = core.run(small_root, "gcrn-copy.small-b2", 3, 0.3, False,
                 device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["calls_completed"]["value"] == r["attempted"] > 0
    assert "silent" not in r["metrics"]
    assert set(r["metrics"]) == {"snapshots_per_s", "setup_s",
                                 "calls_completed"}
    assert list(r)[-1] == "checks"


SEQ_DRIVER = '''
"""Each stream of a group through BoosterSession.run, one after another."""
from pathlib import Path

from bench.harness import core

_replay = core.load_module(Path(__file__).with_name("replay.py"), "driver",
                           "replay")
ingest = _replay.ingest
SESSIONS = []


def make_session(cell, params, n_global, device, inputs):
    SESSIONS.append(_replay.make_session(cell, params, n_global, device))
    return SESSIONS[-1]


def make_call(session, padded, group, port_state):
    def run_each():
        outs, states = [], []
        for j in group:
            session.reset_state()
            outs.append(session.run(padded[j]))
            states.append(port_state(session.state))
        return outs, states
    return run_each, "session.run.each"
'''


def test_new_driver_and_traffic_plan_need_no_code(small_root):
    b = small_root / "bench"
    (b / "drivers/seq.py").write_text(SEQ_DRIVER)
    t = json.loads((b / "traffic/small-b4.json").read_text())
    t.update(driver="seq", streams_per_call=2, plan={"stream_chunk": 4})
    (b / "traffic/small-seq.json").write_text(json.dumps(t))
    (b / "metrics/seq_calls.py").write_text(
        "def read(ctx):\n    return float(sum(c[4] == 'session.run.each'"
        " for c in ctx.calls))\n")
    man = json.loads((small_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "gcrn-m2.small-seq",
                             "config": "gcrn-m2", "traffic": "small-seq",
                             "chips": 1, "why": "added as files"})
    man["end_to_end"].append({"name": "seq_calls", "unit": "calls",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["gcrn-m2.small-seq"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(man))
    r = core.run(small_root, "gcrn-m2.small-seq", 4, 0.3, False,
                 device="cpu")
    assert r["correct"] is True and r["failed"] == 0
    assert r["metrics"]["seq_calls"]["value"] == r["attempted"] >= 2
    assert r["checks"]["streams_unchecked"]["value"] == 0
    session = sys.modules["bench_driver_seq"].SESSIONS[-1]
    # the traffic's plan over the configuration's
    assert session.plan.stream_chunk == 4 and session.plan.level == "v3"
