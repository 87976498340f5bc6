"""The port's config, train step, renderer and loop against the reference
package on the CPU: the same weights, batches and deterministic sampling
(`randomized=False`) give the same losses, gradient norm and updated
parameters after one and three steps, and the same rendered image."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import __main__ as t_cli
from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import Config as TConfig
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import Config as JConfig
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

# The suite runs files in parallel worker processes: one torch thread per
# worker keeps these small CPU tests from crowding the timing-sensitive
# tests of other workers.
torch.set_num_threads(1)

FLAGSHIP = "configs/kitti_mipnerf360.json"
SMALL = [
    "dataset=synthetic", "batch_size=64", "max_steps=3", "lr_delay_steps=0",
    "randomized=false", "exp_dir=unused",
    'model_params={"num_prop_samples": 16, "num_nerf_samples": 8, "num_levels": 3, '
    '"raydist_fn": "reciprocal", "opaque_background": true, "single_jitter": true, '
    '"nerf_mlp_params": {"net_depth": 3, "net_width": 32, "bottleneck_width": 16, '
    '"net_width_viewdirs": 16, "max_deg_point": 4}, '
    '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}',
]
LOG_KEYS = {"step", "loss", "psnr", "rays_per_sec", "rays_per_sec_per_chip", "grad_norm",
            "loss_data", "loss_depth", "loss_interlevel", "loss_distortion"}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_flagship_config_loads_with_the_same_fields():
    assert [f.name for f in dataclasses.fields(TConfig)] == [f.name for f in dataclasses.fields(JConfig)]
    assert dataclasses.asdict(t_load_config(FLAGSHIP)) == dataclasses.asdict(j_load_config(FLAGSHIP))
    assert TConfig() == TConfig(**dataclasses.asdict(JConfig()))


def _to_torch(obj):
    """A reference Batch/Rays/Pixels as the port's, with float32/int32 CPU
    tensors (the reference casts host rays in float64 and runs float32)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


def _flat_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _flat_flax(tree):
    out = {}
    for mod, layers in tree["params"].items():
        for layer, leaves in layers.items():
            out[f"{mod}.{layer}.weight"] = np.asarray(leaves["kernel"]).T
            out[f"{mod}.{layer}.bias"] = np.asarray(leaves["bias"])
    return out


@pytest.fixture(scope="module")
def setup():
    config_j = j_load_config(FLAGSHIP, SMALL)
    config_t = t_load_config(FLAGSHIP, SMALL)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batches = [dataset.sample_batch() for _ in range(3)]
    mesh = parallel.make_mesh(jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
        params0 = jax.device_get(state.params)
        step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                        camtype=dataset.camtype)
        stats_j, params_j = [], []
        for i, b in enumerate(batches):
            state, stats = step_j(state, parallel.shard_batch(b, mesh), jax.random.PRNGKey(i),
                                  i / config_j.max_steps)
            stats_j.append(jax.device_get(stats))
            params_j.append(_flat_flax(jax.device_get(state.params)))
        render_j = j_step.render_image(
            j_step.make_render_fn(config_j, model_j, mesh), params0,
            j_datasets.SyntheticDataset("test", seed=2).image_batch(1), mesh, chunk_size=40,
        )

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    model_r = convert.params_from_flax(params0, t_step.build_model(config_t))
    render_t = t_step.render_image(
        model_r, _to_torch(j_datasets.SyntheticDataset("test", seed=2).image_batch(1)),
        chunk_size=40, device="cpu",
    )
    stats_t, params_t = [], []
    for i, b in enumerate(batches):
        stats_t.append(step_t(_to_torch(b), i, i / config_t.max_steps, None))
        params_t.append(_flat_params(model_t))
    return stats_j, params_j, stats_t, params_t, render_j, render_t


@pytest.mark.parametrize("n_steps", [1, 3])
def test_steps_match_losses_grad_norm_and_params(setup, n_steps):
    stats_j, params_j, stats_t, params_t, _, _ = setup
    sj, st = stats_j[n_steps - 1], stats_t[n_steps - 1]
    assert set(st["loss_terms"]) == set(sj["loss_terms"])
    # Losses are means over rays of float32 terms computed on resampled
    # edges (inverse-CDF roundoff of ~1e-6); the depth term squares
    # distances of up to 10: relative 3e-5.
    for k, v in sj["loss_terms"].items():
        np.testing.assert_allclose(float(st["loss_terms"][k]), float(v), rtol=3e-5, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(st["loss"]), float(sj["loss"]), rtol=3e-5)
    np.testing.assert_allclose(float(st["psnr"]), float(sj["psnr"]), rtol=1e-5)
    # The gradient norm sums squares of every gradient: relative 1e-4.
    np.testing.assert_allclose(float(st["grad_norm"]), float(sj["grad_norm"]), rtol=1e-4)
    # Adam moves each weight by about lr * g / (|g| + 1e-6) <= 2e-3; for
    # clipped gradients near 1e-6 that ratio passes their relative roundoff
    # (~1e-4) on: 2e-5 of absolute slack, 1% of one step.
    pj, pt = params_j[n_steps - 1], params_t[n_steps - 1]
    assert set(pj) == set(pt)
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=2e-5, rtol=1e-5, err_msg=name)


def test_render_image_matches(setup):
    *_, render_j, render_t = setup
    assert set(render_t) == {k for k in render_j if not k.startswith("ray_")}
    for key in render_t:
        assert render_t[key].shape == np.asarray(render_j[key]).shape == render_t[key].shape
        # Distances reach the far bound of 10 through an inverse CDF.
        np.testing.assert_allclose(render_t[key], np.asarray(render_j[key]), atol=2e-5, rtol=1e-4,
                                   err_msg=key)


def test_train_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_loop.train(t_load_config(FLAGSHIP, SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["--config", FLAGSHIP, *SMALL])


def test_cli_trains_and_evaluates_on_cpu(capsys, tmp_path):
    t_cli.main(["--config", FLAGSHIP, "--device", "cpu", *SMALL, "print_every=2",
                "train_render_every=3", f"exp_dir={tmp_path}", "randomized=true"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    train_lines = [x for x in lines if "loss" in x]
    assert [x["step"] for x in train_lines] == [2, 3]
    assert all(set(x) == LOG_KEYS for x in train_lines)
    view = [x for x in lines if "test_view" in x]
    assert len(view) == 1 and view[0]["step"] == 3 and np.isfinite(view[0]["psnr"])
    assert all(np.isfinite(x["loss"]) for x in train_lines)
    assert lines[-1]["split"] == "test" and np.isfinite(lines[-1]["mean"]["psnr"])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        t_loop.train(t_load_config(FLAGSHIP, SMALL + ["compute_dtype=bfloat16"]), device="cpu")
    with pytest.raises(NotImplementedError):
        t_loop.train(t_load_config(FLAGSHIP, ["dataset=driving"]), device="cpu")
