"""A configuration, a traffic mix and a per-layer metric added as files,
with entries in BENCHMARK.json, are found by name and run: no file that is
there is edited."""

import json
import shutil

from perfbench import harness
from perfbench.tests._tiny import tiny_run


def test_new_config_mix_and_metric_drop_in(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT + "/perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT + "/BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())

    config = json.loads((root / "perfbench/configs/mip360_kitti.json").read_text())
    config["name"] = "mip360_wide"
    (root / "perfbench/configs/mip360_wide.json").write_text(json.dumps(config))
    mix = json.loads((root / "perfbench/traffic/train.json").read_text())
    mix["print_every"] = 3
    (root / "perfbench/traffic/train_every3.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/window_steps.train.py").write_text(
        "def read(run, measured):\n    return float(measured.counters['steps'])\n")

    bench["configs"].append({"name": "mip360_wide", "source": "https://example.org/x",
                             "file": "perfbench/configs/mip360_wide.json", "reduced": [],
                             "why": "a drop-in"})
    bench["workloads"].append({"name": "mip360_wide.every3", "config": "mip360_wide",
                               "traffic": "train_every3", "chips": 1, "why": "a drop-in"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mip360_kitti.train" in m["workloads"]:
            m["workloads"].append("mip360_wide.every3")
    bench["per_layer"].append({"name": "window_steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "loop",
                               "moves": "train_rays_per_s", "workloads": ["mip360_wide.every3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("mip360_wide.every3", str(root))
    assert cell.config["name"] == "mip360_wide" and cell.traffic["print_every"] == 3
    assert "window_steps.train" in [m["name"] for m in cell.per_layer]

    run = tiny_run("mip360_wide.every3", tmp_path / "cache", trace=True, root=str(root))
    run.traffic_overrides = {"warmup_steps": 3, "trace_steps": 3}
    result = harness.execute(run)
    assert result["correct"], result["checks"]
    assert result["metrics"]["window_steps.train"]["value"] == 3.0
