"""The readers of the port's own record (`perfbench/program_record.py`):
None without a trace or without the port's tracing module, and, in a
traced CPU run of each cell at tiny sizes, every metric they serve."""

import dataclasses
import sys

import pytest

from perfbench import harness
from perfbench.tests._tiny import TINY, tiny_run

READERS = ("data_wait_ms_per_step", "samples_per_ray", "cast_ms_per_view")


def _served(workload):
    return sorted(m["name"] for m in harness.load_cell(workload).per_layer
                  if harness.base_name(m["name"]) in READERS)


@dataclasses.dataclass
class _Measured:
    counters: dict
    trace: object = None


@pytest.mark.parametrize("reader", READERS)
def test_reader_reads_none_without_a_trace(reader):
    measured = _Measured({"steps": 4, "views": 4})
    assert harness.load_metric(reader).read(None, measured) is None


@pytest.mark.parametrize("reader", READERS)
def test_reader_reads_none_without_the_ports_module(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, "outdoor_nerf_depth_torch.utils.tracing", None)
    measured = _Measured({"steps": 4, "views": 4}, trace=object())
    assert harness.load_metric(reader).read(None, measured) is None


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench-cache")


@pytest.mark.parametrize("workload,expected", [
    ("mip360_kitti.train", ["data_wait_ms_per_step.train"]),
    ("ngp_kitti.train", ["data_wait_ms_per_step.host_paced", "samples_per_ray.host_paced"]),
    ("ngp_kitti.view", ["cast_ms_per_view.view", "samples_per_ray.view"]),
])
def test_traced_run_carries_the_programs_metrics(workload, expected, cache):
    assert _served(workload) == expected
    result = harness.execute(tiny_run(workload, cache, trace=True))
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(expected) <= set(metrics), sorted(metrics)
    for name in expected:
        value = metrics[name]["value"]
        if name.startswith("samples_per_ray"):
            assert 0 < value <= TINY["ngp_kitti"]["model_params"]["max_samples"]
        else:
            assert value > 0


def test_untraced_run_reads_no_program_record(cache):
    result = harness.execute(tiny_run("ngp_kitti.view", cache))
    assert "samples_per_ray.view" not in result["metrics"]
