"""The data-parallel driver on the CPU: four gloo ranks at tiny sizes, one
process each, the step followed by the reference on the global batch. The
four-card cell is not in BENCHMARK.json yet (PERF.md, open questions); these
tests add it to a copy of the checkout."""

import json
import shutil

from perfbench import harness
from perfbench.tests._tiny import tiny_run
from perfbench.tests.test_perfbench_cpu_runs import nan_loss_after

CELL = {"name": "mip360_kitti.train-dp4", "config": "mip360_kitti", "traffic": "train_dp4",
        "chips": 4, "why": "data parallel over four ranks"}


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT + "/perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(open(harness.ROOT + "/BENCHMARK.json").read())
    if CELL["name"] not in [w["name"] for w in bench["workloads"]]:
        bench["workloads"].append(CELL)
        bench["end_to_end"].append({"name": "train_rays_per_s.dp", "unit": "rays/s",
                                    "better": "higher", "bound": 0.25, "source": "host_clock",
                                    "workloads": [CELL["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def test_four_gloo_ranks_train_and_agree_with_the_reference(tmp_path):
    root = _checkout(tmp_path)
    run = tiny_run(CELL["name"], tmp_path / "cache", root=root)
    run.traffic_overrides = {"warmup_steps": 4, "print_every": 2, "trace_steps": 4}
    result = harness.execute(run)
    assert result["correct"], result["checks"]
    assert result["checks"]["batch_rays_off"]["value"] == 0.0
    assert result["attempted"] > 0


def test_exchange_left_out_turns_correct_false(tmp_path, monkeypatch):
    """Rank 0 keeps its own gradient share instead of the all-reduced sum
    (the collective still runs, so no rank waits for it)."""
    from outdoor_nerf_depth_torch import parallel

    orig = parallel.all_reduce_sum_

    def exchange_ignored(tensors):
        kept = [t.clone() for t in tensors]
        orig(tensors)
        for t, k in zip(tensors, kept):
            t.copy_(k)

    monkeypatch.setattr(parallel, "all_reduce_sum_", exchange_ignored)
    root = _checkout(tmp_path)
    run = tiny_run(CELL["name"], tmp_path / "cache", root=root)
    run.traffic_overrides = {"warmup_steps": 4, "print_every": 2, "trace_steps": 4}
    result = harness.execute(run)
    assert not result["correct"], result["checks"]


def test_nonfinite_loss_on_a_rank_counts_as_failed(tmp_path, monkeypatch):
    """Rank 0's loss turns not a number in the window (the other ranks' stay
    finite): the all-reduced count reaches the result."""
    nan_loss_after(monkeypatch, 4)
    root = _checkout(tmp_path)
    run = tiny_run(CELL["name"], tmp_path / "cache", root=root)
    run.traffic_overrides = {"warmup_steps": 4, "print_every": 2, "trace_steps": 4}
    result = harness.execute(run)
    assert result["failed"] > 0 and not result["correct"], result

