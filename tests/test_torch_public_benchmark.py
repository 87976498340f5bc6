"""The port's public-dataset runner against `benchmarks/run_public_benchmark.py`
on the CPU: the suite registry equal, every suite's reader in the port's
`build_dataset`, each scene's config equal field by field to the `Config`
the root `run_scene` trains under (captured by stand-ins for the reference
loop's `train` and `evaluate`), and `main` on a two-scene Blender layout
written by `tools/make_blender_fixture.py` (tiny NGP, 2 steps) writing the
summary with per-scene and mean keys; fault 6 (a black background behind
white Blender views) in both packages."""

import dataclasses
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.tools import make_blender_fixture
from outdoor_nerf_depth_torch.tools import run_public_benchmark as t_bench
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.train import loop as j_loop

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_NGP = json.dumps({
    "scale": 0.5, "max_samples": 16, "n_candidates": 64, "grid_resolution": 16,
    "compute_dtype": "bfloat16",
    "field_params": {"n_levels": 2, "log2_table_size": 10, "base_resolution": 4,
                     "max_resolution": 16, "hidden_width": 16, "geo_features": 7}})
OVERRIDES = ["batch_size=64", f"model_params={TINY_NGP}", "--lr_init=0.5", "exp_dir=elsewhere",
             "render_chunk_size=128"]


@pytest.fixture(scope="module")
def root_tool():
    spec = importlib.util.spec_from_file_location(
        "root_run_public_benchmark", REPO / "benchmarks" / "run_public_benchmark.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_suites_equal_the_root_registry(root_tool):
    assert t_bench.SUITES == root_tool.SUITES
    assert list(t_bench.SUITES) == list(root_tool.SUITES)


def _reference_config(root_tool, monkeypatch, suite, scene, steps, overrides):
    """The Config the root run_scene trains and evaluates under."""
    seen = []
    monkeypatch.setattr(j_loop, "train", lambda config: seen.append(config) or ("state", 0, None))
    monkeypatch.setattr(j_loop, "evaluate",
                        lambda config, state, occupancy=None: ({"psnr": 1.0, "lpips": None}, []))
    assert root_tool.run_scene(suite, "/data/suite", scene, steps, overrides) == {"psnr": 1.0}
    return seen[0]


@pytest.mark.parametrize("name", list(t_bench.SUITES))
@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["defaults", "overrides"])
def test_scene_config_equals_the_reference(root_tool, monkeypatch, name, overrides):
    suite = t_bench.SUITES[name]
    scene = suite["scenes"][-1]
    want = _reference_config(root_tool, monkeypatch, root_tool.SUITES[name], scene, 1234,
                             overrides)
    got = t_bench.scene_config(suite, "/data/suite", scene, 1234, overrides)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


@pytest.mark.parametrize("name", list(t_bench.SUITES))
def test_every_suite_has_a_reader(name, tmp_path):
    """Each suite's `dataset` is a reader of the port's build_dataset: on a
    missing scene it fails reading files, not on the name."""
    config = t_bench.scene_config(t_bench.SUITES[name], str(tmp_path), "absent", 10)
    with pytest.raises(Exception) as info:
        t_loop.build_dataset(config, "train")
    assert "unknown dataset" not in str(info.value)


def test_main_on_a_two_scene_blender_layout(tmp_path, monkeypatch, capsys):
    data = tmp_path / "data"
    for scene in ("lego", "chair"):
        make_blender_fixture.main(str(data / scene), 4, 2, 16)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "summary.json"
    summary = t_bench.main(["synthetic_nerf", f"root={data}", "scenes=lego,chair", "steps=2",
                            f"out={out}", "--device", "cpu", "batch_size=64",
                            f"model_params={TINY_NGP}", "render_chunk_size=128"])
    assert json.loads(out.read_text()) == summary
    assert summary["suite"] == "synthetic_nerf" and list(summary["scenes"]) == ["lego", "chair"]
    keys = {"psnr", "ssim", "test_rays_per_sec"}
    for scene, metrics in summary["scenes"].items():
        assert set(metrics) == keys, scene
        assert all(math.isfinite(v) for v in metrics.values()), scene
        assert (tmp_path / "exp" / "public_bench" / scene / "checkpoints" / "2").is_dir()
    assert set(summary["mean"]) == keys
    for k in keys:
        mean = sum(m[k] for m in summary["scenes"].values()) / 2
        assert summary["mean"][k] == round(mean, 4)
    assert '"psnr"' in capsys.readouterr().out.splitlines()[-1]


def test_unknown_suite_prints_the_usage():
    with pytest.raises(SystemExit, match="usage: run_public_benchmark <synthetic_nerf"):
        t_bench.main(["imagenet", "root=/x", "--device", "cpu"])


def test_fault_6_black_background_behind_white_blender_views_in_both_packages(tmp_path):
    """The runner's config (the reference's) leaves NGP's background at
    (0, 0) while both Blender readers composite the RGBA views over white,
    so every empty pixel costs a full unit of error (phase `public_bench`
    read 2.3 dB after 200 steps on the card)."""
    make_blender_fixture.main(str(tmp_path / "lego"), 2, 1, 8)
    config = t_bench.scene_config(t_bench.SUITES["synthetic_nerf"], str(tmp_path), "lego", 10)
    assert "bg_intensity_range" not in config.model_params
    assert t_step.build_model(config).bg_intensity_range == (0.0, 0.0)
    assert j_build("ngp", **config.model_params).bg_intensity_range == (0.0, 0.0)
    pose = make_blender_fixture.camera_poses(1, 2)[0]  # the test split's first view
    alpha = make_blender_fixture.render_rgba(pose, 8, make_blender_fixture.make_scene())[..., 3]
    assert (alpha == 0).any()
    for reader in (t_datasets.BlenderDataset, j_datasets.BlenderDataset):
        rgb = np.asarray(reader(str(tmp_path / "lego"), "test", global_batch_size=8).images)[0]
        assert np.all(rgb[alpha == 0] == 1.0)
