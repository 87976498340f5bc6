"""The port's Urban Radiance Fields and Gaussian-NLL depth losses against the
reference package on the CPU: the losses and their gradients on seeded
inputs with invalid rays, the dispatcher on interval ('tdist') and
point-sample ('steps'/'lengths') histories, and one train step of each
backend (mip-NeRF 360, Instant-NGP, NeRF++) under each loss from the same
weights on the same batch, with deterministic sampling (`randomized=false`)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.train import losses as t_losses
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.train import losses as j_losses
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

N_RAYS, N_SAMPLES = 48, 16
# Values and gradients are float32 sums over at most 16 samples a ray.
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(seed=0, near=None):
    """A ray batch's weights, sorted sample positions, interval lengths,
    supervised depths (a quarter of them invalid, <= 0) and predictions;
    with `near`, one sample a ray lies within +-near of its depth."""
    rng = np.random.default_rng(seed)
    steps = np.sort(rng.uniform(0.5, 8.0, (N_RAYS, N_SAMPLES)), axis=-1)
    w = rng.uniform(0.0, 1.0, (N_RAYS, N_SAMPLES)) ** 3
    w = w / w.sum(-1, keepdims=True) * rng.uniform(0.5, 1.0, (N_RAYS, 1))
    sup = rng.uniform(1.0, 7.0, N_RAYS)
    if near is not None:
        steps[:, N_SAMPLES // 2] = sup + rng.uniform(-near, near, N_RAYS)
        steps = np.sort(steps, axis=-1)
    sup[rng.uniform(size=N_RAYS) < 0.25] = rng.choice([0.0, -1.0])
    pred = (w * steps).sum(-1) + rng.normal(0.0, 0.3, N_RAYS)
    arrays = dict(weights=w, steps=steps, lengths=rng.uniform(0.05, 0.6, steps.shape),
                  depth_sup=sup, depth_pred=pred, std=rng.uniform(0.1, 1.5, N_RAYS),
                  tdist=np.sort(rng.uniform(0.5, 8.0, (N_RAYS, N_SAMPLES + 1)), axis=-1),
                  dirs=rng.normal(size=(N_RAYS, 3)))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _j_nll(x, std):
    return j_losses.gaussian_nll_depth_loss(x["depth_pred"], x["steps"], x["weights"],
                                            x["depth_sup"], std)


def _t_nll(x, std):
    return t_losses.gaussian_nll_depth_loss(x["depth_pred"], x["steps"], x["weights"],
                                            x["depth_sup"], std)


def _j_urf(x, sigma):
    return j_losses.urban_rf_depth_loss(x["weights"], x["depth_sup"], x["depth_pred"],
                                        x["steps"], sigma)


def _t_urf(x, sigma):
    return t_losses.urban_rf_depth_loss(x["weights"], x["depth_sup"], x["depth_pred"],
                                        x["steps"], sigma)


# The mip config's depth_sigma (0.01) times the KITTI fixture's scene scale
# (0.0985): urf's target there peaks at 1/(sigma/3 * sqrt(2 pi)) ~ 1.2e3, so
# the near-surface term outweighs every other.
CONFIG_SIGMA = 0.01 * 0.0985
# (name, reference loss, port loss, its std or sigma: a scalar or "array"
# for the per-ray std, the inputs' seed, their `near`)
CASES = {
    "nll_scalar_std": (_j_nll, _t_nll, 0.7, 1, None),
    "nll_array_std": (_j_nll, _t_nll, "array", 0, None),
    "nll_tight_std": (_j_nll, _t_nll, 0.05, 2, None),
    "nll_config_std": (_j_nll, _t_nll, CONFIG_SIGMA**0.5, 5, CONFIG_SIGMA**0.5),
    "urf_sigma_1": (_j_urf, _t_urf, 1.0, 4, None),
    "urf_sigma_0.3": (_j_urf, _t_urf, 0.3, 3, None),
    "urf_config_sigma": (_j_urf, _t_urf, CONFIG_SIGMA, 6, CONFIG_SIGMA),
}
GRAD_KEYS = ("weights", "depth_pred")


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_the_reference(case):
    j_fn, t_fn, knob, seed, near = CASES[case]
    x = _inputs(seed, near)
    assert (x["depth_sup"] <= 0).any() and (x["depth_sup"] > 0).any()

    def j_loss(*diff):
        xj = dict({k: jnp.asarray(v) for k, v in x.items()}, **dict(zip(GRAD_KEYS, diff)))
        return j_fn(xj, xj["std"] if knob == "array" else knob)

    want, want_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        *(jnp.asarray(x[k]) for k in GRAD_KEYS))
    xt = {k: torch.from_numpy(v).requires_grad_(k in GRAD_KEYS) for k, v in x.items()}
    got = t_fn(xt, xt["std"] if knob == "array" else knob)
    got.backward()
    assert float(want) > 0
    if j_fn is _j_urf and near is not None:
        assert float(want) > 1e3  # the near-surface peak outweighs the rest
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for key, wg in zip(GRAD_KEYS, want_grads):
        wg = np.asarray(wg)
        assert np.abs(wg).max() > 0, key
        np.testing.assert_allclose(xt[key].grad.numpy(), wg, rtol=RTOL,
                                   atol=RTOL * np.abs(wg).max(), err_msg=key)


def test_nll_counts_only_rays_outside_the_measurement():
    """A prediction inside the measured distribution adds nothing; the sum
    is divided by every ray, valid or not."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(3).items()}
    x["weights"] = torch.zeros_like(x["weights"])
    x["weights"][:, 0] = 1.0
    x["steps"][:, 0] = x["depth_pred"]  # predicted variance 1e-5
    inside = x["depth_sup"] + 0.01
    x["depth_pred"] = inside
    x["steps"][:, 0] = inside
    assert float(t_losses.gaussian_nll_depth_loss(
        x["depth_pred"], x["steps"], x["weights"], x["depth_sup"], 0.5)) == 0.0


@pytest.mark.parametrize("history", ["tdist", "points", "points_fg_far"])
@pytest.mark.parametrize("kind", ["urf", "nll"])
def test_dispatcher_matches_the_reference(kind, history):
    x = _inputs(7)
    if history == "tdist":
        hist = {"weights": x["weights"], "tdist": x["tdist"]}
    else:
        hist = {"weights": x["weights"], "steps": x["steps"], "lengths": x["lengths"]}
    if history == "points_fg_far":  # NeRF++'s mask bound: kl reads it, urf and nll do not
        hist["fg_far"] = np.full(N_RAYS, 3.0, np.float32)
    args = (x["depth_sup"], x["depth_pred"], x["dirs"], 0.45, kind, "mean_valid",
            history == "points_fg_far")
    want = j_losses.depth_loss_from_history({k: jnp.asarray(v) for k, v in hist.items()},
                                            *(jnp.asarray(a) for a in args[:3]), *args[3:])
    got = t_losses.depth_loss_from_history({k: torch.from_numpy(v) for k, v in hist.items()},
                                           *(torch.from_numpy(a) for a in args[:3]), *args[3:])
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    if history == "points_fg_far":
        unmasked = t_losses.depth_loss_from_history(
            {k: torch.from_numpy(v) for k, v in hist.items()},
            *(torch.from_numpy(a) for a in args[:3]), *args[3:6], False)
        assert float(unmasked) == float(got)


def test_dispatcher_rejects_an_unknown_loss():
    x = {k: torch.from_numpy(v) for k, v in _inputs(1).items()}
    with pytest.raises(ValueError, match="unknown depth loss"):
        t_losses.depth_loss_from_history({"weights": x["weights"], "tdist": x["tdist"]},
                                         x["depth_sup"], x["depth_pred"], x["dirs"], 1.0, "huber")


# -- one train step of each backend under each loss ---------------------------

MIP_MODEL = {
    "num_prop_samples": 16, "num_nerf_samples": 8, "num_levels": 3, "raydist_fn": "reciprocal",
    "opaque_background": True, "single_jitter": True,
    "nerf_mlp_params": {"net_depth": 3, "net_width": 32, "bottleneck_width": 16,
                        "net_width_viewdirs": 16, "max_deg_point": 4},
    "prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4},
}
NGP_MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16, sample_budget=8,
                 field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                                   max_resolution=16, hidden_width=16, geo_features=7,
                                   grad_mode="sorted"))
NERFPP_MODEL = dict(cascade_samples=(6, 6), net_depth=2, net_width=16, pos_degrees=4,
                    view_degrees=2)
BACKENDS = {
    "mip": ("configs/kitti_mipnerf360.json", MIP_MODEL),
    "ngp": ("configs/kitti_ngp.json", NGP_MODEL),
    "nerfpp": ("configs/kitti_nerfpp.json", NERFPP_MODEL),
}


def _overrides(backend, kind, sigma=("depth_sigma=0.5",)):
    config, model = BACKENDS[backend]
    return config, [
        "dataset=synthetic", "batch_size=64", "max_steps=3", "lr_delay_steps=0",
        "randomized=false", "exp_dir=unused", f"depth_loss_type={kind}", *sigma,
        "lambda_depth=0.5", "model_params=" + json.dumps(model)]


def _sparse_grid():
    rng = np.random.default_rng(1)
    grid = rng.uniform(0.0, 2.0, (1, 16**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.6] = 0.0
    return grid


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


def _flat_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _one_step(backend, kind, sigma):
    """One train step of each package from the same weights on the same
    batch; returns (reference stats, reference params, port stats, port
    params), the params both as the port's named parameters."""
    path, overrides = _overrides(backend, kind, sigma)
    config_j, config_t = j_load_config(path, overrides), t_load_config(path, overrides)
    assert config_t.depth_loss_type == kind and config_t.lambda_depth > 0
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batch = dataset.sample_batch()
    mesh = parallel.make_mesh(jax.devices()[:1])
    grid = _sparse_grid() if backend == "ngp" else None
    model_j = j_step.build_model(config_j)
    rays0 = j_rays.dummy_rays((8,))
    params0 = jax.device_get(jax.jit(lambda k: model_j.init(
        k, rng=None, rays=rays0, train_frac=1.0, compute_extras=False))(jax.random.PRNGKey(0)))
    state = TrainState.create(apply_fn=model_j.apply, params=params0,
                              tx=j_step.make_optimizer(config_j)[0])
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    aux = () if grid is None else (jnp.asarray(grid),)
    state, stats_j = step_j(state, parallel.shard_batch(batch, mesh), jax.random.PRNGKey(0), 0.0,
                            *aux)
    as_port = lambda tree: _flat_params(convert.params_from_flax(jax.device_get(tree),
                                                                 t_step.build_model(config_t)))
    params_j, grads_j = as_port(state.params), as_port(state.opt_state[0].mu)

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    if grid is not None:
        model_t.occupancy.copy_(torch.from_numpy(grid))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    stats_t = step_t(_to_torch(batch), 0, 0.0, None)
    # Adam's first moment after one step is (1 - beta1) times the gradient.
    grads_t = {n: optimizer.state[p]["exp_avg"].numpy().copy()
               for n, p in model_t.named_parameters()}
    return (jax.device_get(stats_j), params_j, grads_j, stats_t, _flat_params(model_t), grads_t)


# Loss terms: relative 1e-5; mip's sit on proposal-resampled edges, whose
# inverse-CDF roundoff (~1e-6) tests/test_torch_train_step.py holds at 3e-5.
LOSS_RTOL = {"mip": 3e-5, "ngp": 1e-5, "nerfpp": 1e-5}
# The NGP table's gradient: 1e-4 of its largest entry, the bound the NGP step
# tests set on the norm of all gradients (bf16 products round 2^-9 apart).
GRAD_ATOL_OF_MAX = 1e-4


@pytest.mark.parametrize("kind", ["urf", "nll"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_train_step_matches_the_reference(backend, kind):
    _check_step(backend, kind)


@pytest.mark.parametrize("kind", ["urf", "nll"])
def test_mip_step_at_the_config_sigma_matches_the_reference(kind):
    """The mip config's own depth_sigma, scaled as on the KITTI fixture."""
    _check_step("mip", kind, ("depth_sigma=0.01", "depth_scale=0.0985"))


def _check_step(backend, kind, sigma=("depth_sigma=0.5",)):
    stats_j, params_j, grads_j, stats_t, params_t, grads_t = _one_step(backend, kind, sigma)
    assert "depth" in stats_t["loss_terms"]
    assert set(stats_t["loss_terms"]) == set(stats_j["loss_terms"])
    assert float(stats_j["loss_terms"]["depth"]) > 0
    for k, v in stats_j["loss_terms"].items():
        np.testing.assert_allclose(float(stats_t["loss_terms"][k]), float(v),
                                   rtol=LOSS_RTOL[backend], atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(stats_t["loss"]), float(stats_j["loss"]),
                               rtol=LOSS_RTOL[backend])
    np.testing.assert_allclose(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]),
                               rtol=1e-4)
    assert set(params_j) == set(grads_j) == set(params_t) == set(grads_t)
    for name in params_j:
        atol = np.full(params_j[name].shape, 1e-5)
        if name == "field.encoder.table":
            # The NGP table's gradient sums bf16-rounded products: it is held
            # at 1e-4 of its largest entry. Adam's first step moves a weight
            # by lr * g / (|g| + eps), of size below lr, and on an entry whose
            # gradient is within that tolerance of 0 a rounding of g changes
            # that step by a large share of lr (nll: 1.3e-3 seen at lr 0.01).
            # Those entries are held at one step, lr; every other entry,
            # zero-gradient ones included, at 1e-5.
            g = np.abs(grads_j[name])
            grad_atol = GRAD_ATOL_OF_MAX * g.max()
            np.testing.assert_allclose(grads_t[name], grads_j[name], rtol=1e-5,
                                       atol=grad_atol, err_msg=name)
            near_zero = (g > 0) & (g <= grad_atol)
            lr = t_load_config(*_overrides(backend, kind, sigma)).lr_init
            atol[near_zero] = lr
            print(f"{backend}/{kind}: {int(near_zero.sum())} of {g.size} table entries "
                  f"with |g| <= {grad_atol:.3g} held at one Adam step, atol {lr}")
            assert near_zero.mean() < 0.1
        err = np.abs(params_t[name] - params_j[name]) - 1e-5 * np.abs(params_j[name])
        assert (err <= atol).all(), (name, float((err - atol).max()))
