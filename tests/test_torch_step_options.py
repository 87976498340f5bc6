"""Train-step and loop options of the port on the CPU, against the reference
package where it computes the same thing: gradient accumulation over
`grad_accum_steps` chunks (against the port's full batch and the
reference's step at the same K), `weight_decay_mults` (the loss term and
the updated parameters), and the loop's `steps_per_dispatch` (cadences on
crossings, checkpoint labels, the same parameters as one step at a time,
the occupancy refresh under fusion) and profiler window."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.train import checkpoints as t_ckpt
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

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
# Decay on both MLPs, and a name the model lacks (it adds nothing).
DECAY = 'weight_decay_mults={"nerf_mlp": 0.001, "prop_mlp": 0.01, "glo": 1.0}'
RUNS = {"k1": [], "k2": ["grad_accum_steps=2"], "k4": ["grad_accum_steps=4"], "decay": [DECAY]}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


@pytest.fixture(scope="module")
def steps():
    """One step of each run in both packages, from the same weights on the
    same batch; the reference's step for every run but K = 1 (which the
    flagship's parity test holds)."""
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=13)
    batch = dataset.sample_batch()
    mesh = parallel.make_mesh(jax.devices()[:1])
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    out = {}
    for name, extra in RUNS.items():
        config_t = t_load_config(FLAGSHIP, SMALL + extra)
        config_j = j_load_config(FLAGSHIP, SMALL + extra)
        with jax.default_matmul_precision("highest"):
            model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
            params0 = jax.device_get(state.params)
            stats_j = params_j = None
            if name != "k1":
                step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                                camtype=dataset.camtype)
                state, stats_j = step_j(state, parallel.shard_batch(batch, mesh),
                                        jax.random.PRNGKey(1), 0.5)
                stats_j = jax.device_get(stats_j)
                params_j = {n: p.detach().numpy().copy() for n, p in convert.params_from_flax(
                    jax.device_get(state.params), t_step.build_model(config_t)).named_parameters()}
        model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
        optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
        step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
        stats_t = step_t(_to_torch(batch), 0, 0.5, None)
        params_t = {n: p.detach().numpy().copy() for n, p in model_t.named_parameters()}
        out[name] = (stats_t, params_t, stats_j, params_j)
    return out


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_the_full_batch(steps, k):
    stats, params, _, _ = steps[f"k{k}"]
    base, base_params, _, _ = steps["k1"]
    # The reference's test tolerances: loss relative 1e-5 (chunk means of
    # equal chunks), gradient norm 1e-3 (sums of K partial gradients).
    np.testing.assert_allclose(float(stats["loss"]), float(base["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(stats["grad_norm"]), float(base["grad_norm"]), rtol=1e-3)
    for name, p in base_params.items():
        # Adam's first step moves each weight by lr * g / (|g| + eps): the
        # sign of g decides it, and tiny gradients amplify their roundoff.
        np.testing.assert_allclose(params[name], p, atol=2e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_the_reference(steps, k):
    stats, params, stats_j, params_j = steps[f"k{k}"]
    assert set(stats["loss_terms"]) == set(stats_j["loss_terms"])
    # The flagship parity test's tolerances (resampled edges carry ~1e-6).
    for key, v in stats_j["loss_terms"].items():
        np.testing.assert_allclose(float(stats["loss_terms"][key]), float(v), rtol=3e-5,
                                   atol=1e-8, err_msg=key)
    np.testing.assert_allclose(float(stats["loss"]), float(stats_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(stats["psnr"]), float(stats_j["psnr"]), rtol=1e-5)
    np.testing.assert_allclose(float(stats["grad_norm"]), float(stats_j["grad_norm"]), rtol=1e-3)
    for name, p in params_j.items():
        np.testing.assert_allclose(params[name], p, atol=2e-5, rtol=1e-5, err_msg=name)


def test_weight_decay_matches_the_reference(steps):
    stats, params, stats_j, params_j = steps["decay"]
    base = steps["k1"][0]
    assert set(stats["loss_terms"]) == set(stats_j["loss_terms"]) == set(base["loss_terms"]) | {
        "weight"}
    np.testing.assert_allclose(float(stats["loss_terms"]["weight"]),
                               float(stats_j["loss_terms"]["weight"]), rtol=1e-6)
    assert float(stats["loss_terms"]["weight"]) > 0
    np.testing.assert_allclose(float(stats["loss"]), float(stats_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(stats["grad_norm"]), float(stats_j["grad_norm"]), rtol=1e-4)
    for name, p in params_j.items():
        np.testing.assert_allclose(params[name], p, atol=2e-5, rtol=1e-5, err_msg=name)


def test_grad_accum_needs_equal_chunks():
    config = t_load_config(FLAGSHIP, SMALL + ["grad_accum_steps=3"])
    model = t_step.build_model(config)
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=13)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        t_step.make_train_step(config, model, optimizer, lr_fn, cameras=cams)(
            _to_torch(dataset.sample_batch()), 0, 0.5, None)


# -- the loop: K steps per iteration --------------------------------------

LOOP = ["dataset=synthetic", "batch_size=32", "lr_delay_steps=0",
        'model_params={"num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 2, '
        '"nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8, '
        '"net_width_viewdirs": 8, "max_deg_point": 4}, '
        '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}',
        "render_chunk_size=64"]


def _train(tmp_path, *extra, name="exp"):
    lines = []
    config = t_load_config(FLAGSHIP, LOOP + [f"exp_dir={tmp_path / name}", *extra])
    model, history = t_loop.train(config, device="cpu", log_fn=lines.append)
    return config, model, history, [json.loads(x) for x in lines]


def test_dispatch_fusion_fires_cadences_on_crossings(tmp_path):
    """K = 8 with cadences of 12 over 32 steps: an iteration ends at 8, 16,
    24 and 32, so each cadence fires where it crosses 12 and 24 (at 16 and
    24), print and checkpoint also at max_steps; `step % 12 == 0` would
    never fire."""
    config, _, history, lines = _train(
        tmp_path, "max_steps=32", "steps_per_dispatch=8", "print_every=12",
        "checkpoint_every=12", "train_render_every=12", "keep_checkpoints=5")
    assert [h["step"] for h in history] == [16, 24, 32]
    assert [x["step"] for x in lines if "test_view" in x] == [16, 24]
    ckpt_dir = os.path.join(config.exp_dir, "checkpoints")
    assert sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()) == [16, 24, 32]
    # The checkpoint labelled N holds N trained steps, Adam's count too.
    for n in (16, 24, 32):
        state, step = t_ckpt.CheckpointManager(ckpt_dir).restore(n)
        assert step == state["step"] == n
        adam = state["optimizer"]["state"][0]["step"]
        assert int(adam) == n
    # A rerun finds the run complete and trains nothing.
    _, _, again, _ = _train(tmp_path, "max_steps=32", "steps_per_dispatch=8")
    assert again == []


def test_fused_steps_equal_single_steps(tmp_path):
    """K = 4 over 8 steps ends with the parameters of 8 single steps on the
    same batches and draws (randomized sampling, one generator)."""
    _, fused, fused_hist, _ = _train(tmp_path, "max_steps=8", "steps_per_dispatch=4",
                                     "print_every=4", name="fused")
    _, single, single_hist, _ = _train(tmp_path, "max_steps=8", "print_every=4",
                                       name="single")
    assert [h["step"] for h in fused_hist] == [h["step"] for h in single_hist] == [4, 8]
    for a, b in zip(fused_hist, single_hist):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for (name, p), (_, q) in zip(fused.named_parameters(), single.named_parameters()):
        assert torch.equal(p, q), name


def test_occupancy_refresh_under_fusion(monkeypatch, tmp_path):
    """K = 4 with a refresh every 3 steps over 8: the refresh falls due at 0
    (warmup) and before the iteration starting at 4, which has crossed 3."""
    calls = []
    make = t_step.make_occupancy_update_fn

    def recording(config, model):
        update = make(config, model)

        def wrapped(grid, generator, warmup):
            calls.append(warmup)
            return update(grid, generator, warmup)

        return wrapped

    monkeypatch.setattr(t_step, "make_occupancy_update_fn", recording)
    model_params = dict(scale=0.5, max_samples=8, n_candidates=32, grid_resolution=8,
                        field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                                          max_resolution=16, hidden_width=16, geo_features=7))
    config = t_load_config("configs/kitti_ngp.json", [
        "dataset=synthetic", "batch_size=32", "max_steps=8", "steps_per_dispatch=4",
        "occupancy_update_every=3", "occupancy_warmup_steps=2",
        "occupancy_cells_per_update=64", "print_every=8", "checkpoint_every=8",
        f"exp_dir={tmp_path}", "model_params=" + json.dumps(model_params)])
    t_loop.train(config, device="cpu", log_fn=lambda line: None)
    assert calls == [True, False]


@pytest.mark.parametrize("start,num,trace", [(2, 1, "steps_0_4.json"),
                                             (10, 5, "steps_8_12.json")])
def test_profiler_window_closes_and_writes_a_trace(tmp_path, start, num, trace):
    """A window narrower than K = 4 (steps [2, 3)) starts and stops within
    one iteration; a window past max_steps stops when the loop ends."""
    config, _, _, _ = _train(tmp_path, "max_steps=12", "steps_per_dispatch=4",
                             f"profile_start_step={start}", f"profile_num_steps={num}",
                             "print_every=12")
    trace_dir = os.path.join(config.exp_dir, "trace")
    assert os.listdir(trace_dir) == [trace]
    with open(os.path.join(trace_dir, trace)) as f:
        assert json.load(f)["traceEvents"]
    assert not torch.autograd.profiler._is_profiler_enabled
