"""Whole runs of each cell on the CPU at tiny sizes: the program agrees with
the reference, and each fault planted underneath the timed path turns
`correct` false."""

import json

import pytest
import torch

from perfbench import harness
from perfbench.tests._tiny import tiny_run


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench-cache")


@pytest.mark.parametrize("workload", ["mip360_kitti.train", "ngp_kitti.train", "ngp_kitti.view"])
def test_sound_run_is_correct(workload, cache):
    result = harness.execute(tiny_run(workload, cache))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(workload).end_to_end}
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(cache):
    result = harness.execute(tiny_run("mip360_kitti.train", cache, trace=True))
    assert result["correct"]
    assert "scene_load_s" in result["metrics"] and "mfu_pct.train" in result["metrics"]
    assert "volren_weights_roofline" not in result["metrics"]  # no card: nothing to read
    assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])
    assert result["device"]["window_s"] > 0


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Every loss term over the first half of the rays: the mean over the rest."""
    from outdoor_nerf_depth_torch.data import rays as rays_lib
    from outdoor_nerf_depth_torch.train import step as step_lib

    orig = step_lib._total_loss

    def first_half(x, n):
        if isinstance(x, torch.Tensor):
            return x[: x.shape[0] // 2] if x.dim() and x.shape[0] == n else x
        if isinstance(x, dict):
            return {k: first_half(v, n) for k, v in x.items()}
        if isinstance(x, list):
            return [first_half(v, n) for v in x]
        return x

    def half(config, batch, renderings, ray_history, rays, share=None):
        n = batch.rgb.shape[0]
        cut = lambda t: t[: n // 2] if isinstance(t, torch.Tensor) and t.shape[:1] == (n,) else t
        return orig(config, rays_lib.map_fields(cut, batch), first_half(renderings, n),
                    first_half(ray_history, n), rays_lib.map_fields(cut, rays), share)

    monkeypatch.setattr(step_lib, "_total_loss", half)


def _altered_answer(monkeypatch):
    from outdoor_nerf_depth_torch.train import step as step_lib

    orig = step_lib.render_image

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["rgb"][0, 0, 0] += 0.05
        return out

    monkeypatch.setattr(step_lib, "render_image", altered)


@pytest.mark.parametrize("workload,fault", [
    ("mip360_kitti.train", _unchanged_step),
    ("ngp_kitti.train", _unchanged_step),
    ("mip360_kitti.train", _half_batch),
    ("ngp_kitti.train", _half_batch),
    ("ngp_kitti.view", _altered_answer),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_turns_correct_false(workload, fault, cache, monkeypatch):
    fault(monkeypatch)
    result = harness.execute(tiny_run(workload, cache))
    assert not result["correct"], result["checks"]


def nan_loss_after(monkeypatch, n_steps: int):
    """Every loss term not a number from the step after `n_steps` on."""
    from outdoor_nerf_depth_torch.train import step as step_lib

    orig, calls = step_lib._total_loss, [0]

    def nan_later(*args, **kwargs):
        terms, stats = orig(*args, **kwargs)
        calls[0] += 1
        if calls[0] > n_steps:
            terms = {k: v * float("nan") for k, v in terms.items()}
        return terms, stats

    monkeypatch.setattr(step_lib, "_total_loss", nan_later)


def test_nonfinite_window_loss_counts_as_failed(cache, monkeypatch):
    nan_loss_after(monkeypatch, 4)  # the followed steps and the warm-up stay sound
    result = harness.execute(tiny_run("mip360_kitti.train", cache))
    assert result["failed"] > 0 and not result["correct"], result

