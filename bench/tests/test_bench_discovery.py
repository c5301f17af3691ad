"""A configuration, a traffic mix and a metric added as files of their
own are found by name, with no edit to the harness."""
import json
import shutil

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
