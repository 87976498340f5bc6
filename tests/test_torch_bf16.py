"""bfloat16 compute (`compute_dtype="bfloat16"`) of the port against the
reference package on the CPU: one dense layer to within one bf16 ulp, the
mip-NeRF 360, NeRF++ and Instant-NGP renderings, and one train step of each
model, from the same Flax weights (converted by `params_from_flax`; they
stay float32 under bf16) on the same rays and batches, deterministic path.

Tolerances: a bf16 product rounds to 8 significant bits (relative 2^-8 =
3.9e-3), and the two packages sum each product's f32 partial sums in
other orders, so a value near a rounding boundary can land one bf16 ulp
apart and pass that on through the later layers, the compositing and the
proposal resampling: atol 5e-3 on colours and opacities in [0, 1] and
relative 1e-2 on depths of a rendering (7e-4 and 2.3e-3 seen on the mip
model); relative 2e-2 on losses and gradient norms, whose bf16 gradients
(bias gradients are sums of bf16 cotangents) differ by up to 4e-3. Each
test also holds the port's bf16 result apart from its float32 one.
"""

import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.models import build as t_build
from outdoor_nerf_depth_torch.models.mlps import Dense as TDense
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

RGB_ATOL, DEPTH_REL, REL = 5e-3, 1e-2, 2e-2
# Each model at 2-3 layers of width 32-64, computing in bf16.
MIP = dict(num_prop_samples=16, num_nerf_samples=8, num_levels=3, raydist_fn="reciprocal",
           opaque_background=True, single_jitter=True,
           nerf_mlp_params=dict(net_depth=3, net_width=64, bottleneck_width=32,
                                net_width_viewdirs=32, max_deg_point=4),
           prop_mlp_params=dict(net_depth=2, net_width=32, max_deg_point=4))
NERFPP = dict(cascade_samples=(8, 8), net_depth=3, net_width=64, pos_degrees=4, view_degrees=2)
NGP = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16,
           field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                             max_resolution=16, hidden_width=32, geo_features=7,
                             grad_mode="sorted"))
MODELS = {"mipnerf360": MIP, "nerfpp": NERFPP, "ngp": NGP}
CONFIGS = {"mipnerf360": "configs/kitti_mipnerf360.json", "nerfpp": "configs/kitti_nerfpp.json",
           "ngp": "configs/kitti_ngp.json"}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), for bf16 values x."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_dense_layer_within_one_bf16_ulp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 40)).astype(np.float32)
    kernel = (rng.normal(size=(40, 24)) / np.sqrt(40)).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    layer = nn.Dense(24, dtype=jnp.bfloat16)
    want = layer.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    t_layer = TDense(40, 24, "bfloat16")
    f32_layer = TDense(40, 24, "float32")
    with torch.no_grad():
        for m in (t_layer, f32_layer):
            m.weight.copy_(torch.from_numpy(kernel.T.copy()))
            m.bias.copy_(torch.from_numpy(bias))
        got = t_layer(torch.from_numpy(x))
        f32 = f32_layer(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and t_layer.weight.dtype == torch.float32
    got = got.float().numpy()
    err = np.abs(got - want)
    assert np.all(err <= _bf16_ulp(want)), float(np.max(err / _bf16_ulp(want)))
    # Not a float32 layer in disguise: the bf16 roundings show.
    assert np.max(np.abs(got - f32.numpy())) > 1e-3


def _nerfpp_rays(n=32, seed=0):
    """Rays from inside the unit sphere with per-ray near bounds."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) * rng.uniform(0.7, 1.5, (n, 1))
    fields = dict(origins=rng.uniform(-0.5, 0.5, (n, 3)), directions=d,
                  viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  radii=np.full((n, 1), 1e-3), imageplane=np.zeros((n, 2)),
                  lossmult=np.ones((n, 1)), near=rng.uniform(1e-4, 0.05, (n, 1)),
                  far=np.full((n, 1), 2.0))
    return {k: v.astype(np.float32) for k, v in fields.items()}


def _image_rays(n=64):
    batch = j_datasets.SyntheticDataset("test", global_batch_size=16, seed=3).image_batch(0)
    flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])[:n]
            for k, v in dataclasses.asdict(batch.rays).items() if v is not None}
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in flat.items()}


def _ngp_rays(n=48, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    fields = dict(origins=rng.uniform(-0.25, 0.25, (n, 3)), directions=d,
                  viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  radii=np.full((n, 1), 1e-3), imageplane=np.zeros((n, 2)),
                  lossmult=np.ones((n, 1)), near=np.full((n, 1), 0.01),
                  far=np.full((n, 1), 30.0))
    return {k: v.astype(np.float32) for k, v in fields.items()}


def _sparse_grid(seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.0, 2.0, (1, 16**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.6] = 0.0
    return grid


def _rendering(name, fields, dtype, jax_side):
    """The finest rendering of `name` built with `dtype` from the reference's
    weights (initialized in bf16, float32 params) on `fields`."""
    fields = dict(fields, cam_idx=np.zeros((len(fields["origins"]), 1), np.int32))
    params = dict(MODELS[name], compute_dtype="bfloat16")
    j_model = j_build(name, **params)
    jr = j_rays.Rays(**{k: jnp.asarray(v) for k, v in fields.items()})
    kwargs = {"occupancy": jnp.asarray(_sparse_grid())} if name == "ngp" else {}
    j_vars = jax.device_get(jax.jit(lambda k: j_model.init(
        k, rng=None, rays=jr, train_frac=1.0, compute_extras=False, **kwargs))(
        jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_leaves(j_vars)
    assert all(leaf.dtype == np.float32 for leaf in leaves)  # params stay f32 under bf16
    if jax_side:
        out, _ = jax.jit(lambda v: j_model.apply(v, None, jr, train_frac=0.5,
                                                 compute_extras=True, **kwargs))(j_vars)
        return {k: np.asarray(out[-1][k]) for k in ("rgb", "distance_mean", "acc")}
    t_model = convert.params_from_flax(j_vars, t_build(name, **dict(params, compute_dtype=dtype)))
    assert all(p.dtype == torch.float32 for p in t_model.parameters())
    tr = t_rays.Rays(**{k: torch.from_numpy(v) for k, v in fields.items()})
    t_kwargs = {"occupancy": torch.from_numpy(_sparse_grid())} if name == "ngp" else {}
    with torch.no_grad():
        out, _ = t_model(tr, train_frac=0.5, compute_extras=True, generator=None, **t_kwargs)
    return {k: out[-1][k].numpy() for k in ("rgb", "distance_mean", "acc")}


RAYS = {"mipnerf360": _image_rays, "nerfpp": _nerfpp_rays, "ngp": _ngp_rays}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_renderings_match(name):
    fields = RAYS[name]()
    want = _rendering(name, fields, "bfloat16", jax_side=True)
    got = _rendering(name, fields, "bfloat16", jax_side=False)
    got_f32 = _rendering(name, fields, "float32", jax_side=False)
    for key in ("rgb", "acc"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], atol=RGB_ATOL, err_msg=key)
    np.testing.assert_allclose(got["distance_mean"], want["distance_mean"], rtol=DEPTH_REL,
                               atol=1e-3, err_msg="distance_mean")
    # The bf16 path really rounds: it is not the float32 rendering.
    assert np.max(np.abs(got["rgb"] - got_f32["rgb"])) > 1e-4


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


def _step_overrides(name):
    params = dict(MODELS[name])
    if name == "ngp":
        params["sample_budget"] = 8
    return ["dataset=synthetic", "batch_size=64", "max_steps=3", "lr_delay_steps=0",
            "randomized=false", "exp_dir=unused", "compute_dtype=bfloat16",
            "model_params=" + json.dumps(params)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_train_step_matches(name):
    overrides = _step_overrides(name)
    config_j = j_load_config(CONFIGS[name], overrides)
    config_t = t_load_config(CONFIGS[name], overrides)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batch = dataset.sample_batch()
    mesh = parallel.make_mesh(jax.devices()[:1])
    aux = jnp.asarray(_sparse_grid(1)) if name == "ngp" else None
    model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    _, stats_j = step_j(state, parallel.shard_batch(batch, mesh), jax.random.PRNGKey(0), 0.0,
                        aux)
    stats_j = jax.device_get(stats_j)

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    if name == "ngp":
        model_t.occupancy.copy_(torch.from_numpy(_sparse_grid(1)))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    stats_t = step_t(_to_torch(batch), 0, 0.0, None)
    config_f32 = config_t.replace(compute_dtype="float32")
    model_f32 = convert.params_from_flax(params0, t_step.build_model(config_f32))
    if name == "ngp":
        model_f32.occupancy.copy_(torch.from_numpy(_sparse_grid(1)))
    optimizer, lr_fn = t_step.make_optimizer(config_f32, model_f32)
    stats_f32 = t_step.make_train_step(config_f32, model_f32, optimizer, lr_fn,
                                       cameras=cams)(_to_torch(batch), 0, 0.0, None)

    assert set(stats_t["loss_terms"]) == set(stats_j["loss_terms"])
    for k, v in stats_j["loss_terms"].items():
        np.testing.assert_allclose(float(stats_t["loss_terms"][k]), float(v), rtol=REL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(stats_t["loss"]), float(stats_j["loss"]), rtol=REL)
    np.testing.assert_allclose(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]),
                               rtol=REL)
    assert all(p.dtype == torch.float32 for p in model_t.parameters())
    # The float32 step's gradient norm is another (1.2e-4 to 2.3e-3 relative).
    assert abs(float(stats_t["grad_norm"]) / float(stats_f32["grad_norm"]) - 1) > 2e-5


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_model_takes_the_dtype_from_the_config(name):
    config = t_load_config(CONFIGS[name], _step_overrides(name))
    model = t_step.build_model(config)
    dense = [m for m in model.modules() if isinstance(m, TDense)]
    assert dense and all(m.compute_dtype == torch.bfloat16 for m in dense)
    # model_params["compute_dtype"] wins over the config's, as in the reference.
    override = dict(config.model_params, compute_dtype="float32")
    model = t_step.build_model(config.replace(model_params=override))
    assert all(m.compute_dtype == torch.float32 for m in model.modules()
               if isinstance(m, TDense))
