"""The port's checkpoint tools on tiny CPU runs of the KITTI fixture:
`tools/slim_checkpoint.py`, `tools/eval_budget_checkpoint.py` and
`tools/fixture_ablation.py`, their output held to the structure of the
reference tools' (root `tools/`) and of the artifacts they wrote
(`QUALITY_full_r05.json`'s partial entry, `SWEEP_ABLATION_r05.json`)."""

import json
import os
import pathlib
import sys

import pytest
import torch

from outdoor_nerf_depth_torch.tools import eval_budget_checkpoint, fixture_ablation
from outdoor_nerf_depth_torch.tools import make_kitti_fixture, slim_checkpoint
from outdoor_nerf_depth_torch.tools.full_budget_run import RUNS
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
MIP_MODEL = ('model_params={"num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 3, '
             '"raydist_fn": "reciprocal", "opaque_background": true, "single_jitter": true, '
             '"nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8, '
             '"net_width_viewdirs": 8, "max_deg_point": 4}, '
             '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}')
NGP_MODEL = "model_params=" + json.dumps(dict(
    scale=8.0, max_samples=16, n_candidates=64, grid_resolution=16, sample_budget=8,
    field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
                      hidden_width=16, geo_features=7)))
TINY = ["batch_size=64", "print_every=1000", "use_native_batcher=false"]


@pytest.fixture(autouse=True)
def _jsonl_logs_only(monkeypatch):
    """The metric writer without TensorBoard (importing it pulls in TensorFlow)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    make_kitti_fixture.main(str(root), 12, 32, 96)  # test view 9
    return root


def _train(config_path, exp_dir, scene, model, steps=2):
    config = load_config(config_path, [f"scene_dir={scene}", f"exp_dir={exp_dir}",
                                       f"max_steps={steps}", model, *TINY])
    t_loop.train(config, device="cpu", log_fn=lambda line: None)
    return config


@pytest.fixture(scope="module")
def ngp_exp(fixture_root, tmp_path_factory):
    exp = tmp_path_factory.mktemp("ngp_exp")
    config = _train(RUNS["ngp"]["config"], exp, fixture_root / "dtu_format", NGP_MODEL)
    return exp, config


@pytest.mark.parametrize("keep", [True, False])
def test_slim_checkpoint_holds_the_trained_parameters(ngp_exp, tmp_path, capsys, keep):
    exp, config = ngp_exp
    out = tmp_path / "slim.pt"
    slim_checkpoint.main([str(exp), str(out)] + (["--keep-occupancy"] if keep else []))
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"wrote {out} (step 2, ")
    assert line.endswith(f"occupancy={'kept' if keep else 'dropped'})")
    payload = ckpt_lib.load_slim(str(out))
    assert set(payload) == {"params", "meta", "step"} | ({"occupancy"} if keep else set())
    assert payload["step"] == 2 and payload["meta"] == {"model": "ngp", "hash_function": "linear"}
    full, step = t_step.load_checkpoint(config)
    assert step == 2
    assert set(payload["params"]) == {n for n, _ in full.named_parameters()}
    for name, p in full.named_parameters():
        assert torch.equal(payload["params"][name], p.detach()), name
    if keep:
        assert torch.equal(payload["occupancy"], full.occupancy)
        # The slim file restores the same model, grid included.
        slim, slim_step = t_step.load_checkpoint(config.replace(slim_checkpoint=str(out)))
        assert slim_step == 2
        for name, value in full.state_dict().items():
            assert torch.equal(slim.state_dict()[name], value), name
    # No optimizer state: the slim file is smaller than the checkpoint.
    state_file = exp / "checkpoints" / "2" / ckpt_lib.STATE_FILENAME
    assert os.path.getsize(out) < os.path.getsize(state_file)


def test_slim_checkpoint_default_path(ngp_exp, capsys):
    exp, _ = ngp_exp
    slim_checkpoint.main([str(exp)])
    assert (exp / "slim.pt").is_file()
    assert capsys.readouterr().out.startswith(f"wrote {exp / 'slim.pt'} (step 2")


def test_slim_checkpoint_of_an_empty_experiment_is_an_error(tmp_path):
    config = load_config(RUNS["mip"]["config"], [f"exp_dir={tmp_path}"])
    from outdoor_nerf_depth_torch.train.config import save_config

    save_config(config, str(tmp_path / "config.json"))
    with pytest.raises(SystemExit, match="no checkpoint found under"):
        slim_checkpoint.main([str(tmp_path)])
    assert not (tmp_path / "slim.pt").exists()


def test_eval_budget_checkpoint_writes_a_partial_entry(fixture_root, tmp_path, capsys):
    exp_root = tmp_path / "full_budget"
    _train(RUNS["mip"]["config"], exp_root / "mip", fixture_root / "dtu_format", MIP_MODEL, 3)
    out = tmp_path / "quality.json"
    # Another backend's entry already in the artifact is kept.
    out.write_text(json.dumps({"device": "earlier", "runs": [{"backend": "ngp", "steps": 1}]}))
    eval_budget_checkpoint.main([
        "backend=mip", f"out={out}", f"fixture={fixture_root}", f"exp_root={exp_root}",
        "note=cut at 3", "--device", "cpu", MIP_MODEL, "batch_size=64"])
    entry = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    written = json.loads(out.read_text())
    assert written["device"] == "earlier"
    assert [r["backend"] for r in written["runs"]] == ["ngp", "mip"]
    assert written["runs"][-1] == entry
    # The reference tool's entry, as its partial NGP run wrote it.
    reference = json.loads((REPO / "QUALITY_full_r05.json").read_text())
    ref_entry = next(r for r in reference["runs"] if r.get("partial"))
    assert set(entry) == set(ref_entry)
    assert entry["partial"] is True and entry["steps"] == 3 and entry["batch"] == 64
    assert entry["budget_steps"] == RUNS["mip"]["steps"] == 75000 and entry["note"] == "cut at 3"
    for key in ("psnr", "ssim", "rmse", "abs_rel", "test_rays_per_sec"):
        assert key in entry["metrics"], key


def test_eval_budget_checkpoint_and_ablation_errors(fixture_root, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        eval_budget_checkpoint.main(["backend=ngp", f"fixture={fixture_root}",
                                     f"exp_root={tmp_path}", f"out={tmp_path / 'q.json'}",
                                     "--device", "cpu"])
    assert not (tmp_path / "q.json").exists()
    with pytest.raises(ValueError, match="unknown backend"):
        eval_budget_checkpoint.main(["backend=tensorf", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (eval_budget_checkpoint.main, fixture_ablation.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["backend=mip"])


def test_fixture_ablation_points_and_checks(fixture_root, tmp_path, capsys):
    out = tmp_path / "ablation.json"
    argv = [f"out={out}", f"fixture={fixture_root}", f"exp_root={tmp_path / 'exp'}", "steps=2",
            "sample_every=4", "backend=mip", "--device", "cpu", MIP_MODEL, *TINY]
    fixture_ablation.main(argv)
    got = json.loads(out.read_text())
    reference = json.loads((REPO / "SWEEP_ABLATION_r05.json").read_text())
    assert set(got) == set(reference)
    assert list(got["points"]) == list(reference["points"])
    for name, point in got["points"].items():
        assert set(point) == set(reference["points"][name]), name
    assert set(got["qualitative_checks"]) == set(reference["qualitative_checks"])
    assert all(isinstance(v, bool) for v in got["qualitative_checks"].values())
    assert got["config"].endswith("configs/kitti_mipnerf360.json")
    # A second run keeps the points it finds and trains none.
    capsys.readouterr()
    fixture_ablation.main(argv)
    assert capsys.readouterr().out.count(": cached ===") == len(reference["points"])


def test_fixture_ablation_checks_equal_the_reference_artifact():
    """The qualitative checks computed on the reference run's points are the
    checks that run recorded."""
    reference = json.loads((REPO / "SWEEP_ABLATION_r05.json").read_text())
    assert fixture_ablation.qualitative_checks(reference["points"]) == \
        reference["qualitative_checks"]
    assert [name for name, _ in fixture_ablation.grid()] == list(reference["points"])
