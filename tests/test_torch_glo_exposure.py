"""The mip-NeRF 360 options at the model and train-step level, the port
against the reference package on the CPU: GLO embeddings, learned exposure
scaling, cylinder rays and the Ref-NeRF fields inside `ProposalModel` under
`zero_glo` True and False, the `ray_*` visualization extras, the renderer
with density normals under no_grad, three train steps with every option and
the rawnerf, orientation and predicted-normal losses on, remat none, dots
and full under density normals, and the reference's `init_state`, which
leaves the GLO and exposure embeddings out (the port's model owns them).

Tolerances: resampled edges go through an inverse CDF whose slope amplifies
float32 roundoff of the weights (2e-5 in normalized distance) and weights
difference transmittances over those edges (5e-5), as in
tests/test_torch_models.py; colours, roughness and the `ray_*` arrays at
2e-5; normals as set out at NORMALS_ATOL; distances up to the far bound at
relative 1e-4.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamNotFoundError
from flax.linen.linear import default_embed_init
from flax.training.train_state import TrainState

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.models import build as t_build
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

N_CAMS = 6
# A normal is a gradient divided by its length: where the density barely
# changes, the two packages' float32 roundoff of the gradient (other sums
# through the trunk's backward) turns a larger angle. Per-sample normals at
# 1e-4 (7.4e-5 seen), composited ones at 5e-5 (2.2e-5 seen).
NORMALS_ATOL = 1e-4
NERF = dict(net_depth=2, net_width=32, bottleneck_width=16, net_width_viewdirs=16,
            max_deg_point=4, compute_density_normals=True, enable_pred_normals=True,
            use_directional_enc=True, use_reflections=True, enable_pred_roughness=True,
            use_n_dot_v=True)
PROP = dict(net_depth=2, net_width=16, max_deg_point=4, compute_density_normals=True,
            enable_pred_normals=True)
MODEL = dict(num_prop_samples=16, num_nerf_samples=8, num_levels=3, raydist_fn="reciprocal",
             opaque_background=True, single_jitter=True, ray_shape="cylinder",
             num_glo_features=4, num_glo_embeddings=N_CAMS, learned_exposure_scaling=True,
             vis_num_rays=5, nerf_mlp_params=NERF, prop_mlp_params=PROP)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _rays(seed=3):
    """One synthetic test view's rays (float32), each on a random camera."""
    batch = j_datasets.SyntheticDataset("test", global_batch_size=16, seed=seed).image_batch(0)
    flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
            for k, v in dataclasses.asdict(batch.rays).items() if v is not None}
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in flat.items()}
    flat["cam_idx"] = np.random.default_rng(seed).integers(
        0, N_CAMS, flat["cam_idx"].shape).astype(np.int32)
    return j_rays.Rays(**flat), t_rays.Rays(**{k: torch.from_numpy(v) for k, v in flat.items()})


def _init(j_model):
    """Flax variables with the GLO and exposure embeddings (zero_glo=False);
    the exposure offsets moved off zero so they matter."""
    variables = jax.device_get(jax.jit(lambda k: j_model.init(
        k, rng=None, rays=j_rays.dummy_rays((8,)), train_frac=1.0, compute_extras=False,
        zero_glo=False))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    expo = variables["params"]["exposure_scaling"]["embedding"]
    variables["params"]["exposure_scaling"]["embedding"] = rng.uniform(
        -0.2, 0.2, expo.shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def models():
    j_model = j_build("mipnerf360", **MODEL)
    variables = _init(j_model)
    t_model = convert.params_from_flax(variables, t_build("mipnerf360", **MODEL))
    return j_model, variables, t_model


@pytest.mark.parametrize("zero_glo", [False, True])
def test_levels_match(models, zero_glo):
    j_model, variables, t_model = models
    jr, tr = _rays()
    j_render, j_hist = jax.device_get(jax.jit(lambda v, r: j_model.apply(
        v, None, r, train_frac=0.5, compute_extras=True, zero_glo=zero_glo))(variables, jr))
    t_render, t_hist = t_model(tr, train_frac=0.5, compute_extras=True, zero_glo=zero_glo)
    for level in range(MODEL["num_levels"]):
        msg = f"level {level}"
        th, jh, trn, jrn = t_hist[level], j_hist[level], t_render[level], j_render[level]
        assert set(trn) == set(jrn), msg
        np.testing.assert_allclose(th["sdist"].detach().numpy(), jh["sdist"], atol=2e-5,
                                   err_msg=msg)
        np.testing.assert_allclose(th["weights"].detach().numpy(), jh["weights"], atol=5e-5,
                                   err_msg=msg)
        for key in ("normals", "normals_pred"):
            np.testing.assert_allclose(th[key].detach().numpy(), jh[key], atol=NORMALS_ATOL,
                                       err_msg=f"{msg} {key}")
            np.testing.assert_allclose(trn[key].detach().numpy(), jrn[key], atol=5e-5,
                                       err_msg=f"{msg} {key}")
        for key in ("rgb", "acc", "ray_sdist", "ray_weights", "ray_rgbs") + (
                ("roughness",) if level == 2 else ()):
            np.testing.assert_allclose(trn[key].detach().numpy(), jrn[key], atol=2e-5,
                                       err_msg=f"{msg} {key}")
        np.testing.assert_allclose(trn["distance_mean"].detach().numpy(), jrn["distance_mean"],
                                   rtol=1e-4, err_msg=msg)
        assert trn["ray_sdist"].shape == (5, th["sdist"].shape[-1])
    # The proposal levels show the final level's composited colour.
    final = t_render[-1]
    want = torch.sum(final["ray_rgbs"] * final["ray_weights"][..., None], dim=-2)
    for r in t_render[:-1]:
        assert torch.equal(r["ray_rgbs"], want[:, None, :].expand(r["ray_rgbs"].shape))


def test_exposure_gets_a_gradient_and_eval_ignores_the_embeddings(models):
    _, variables, _ = models
    t_model = convert.params_from_flax(variables, t_build("mipnerf360", **MODEL))
    _, tr = _rays()
    renderings, _ = t_model(tr, zero_glo=False)
    torch.mean((renderings[-1]["rgb"] - 0.2) ** 2).backward()
    assert float(t_model.exposure_scaling.weight.grad.abs().sum()) > 0
    assert float(t_model.glo.weight.grad.abs().sum()) > 0
    with torch.no_grad():
        a = t_model(tr, zero_glo=True)[0][-1]["rgb"]
        t_model.exposure_scaling.weight.add_(0.5)
        t_model.glo.weight.add_(1.0)
        b = t_model(tr, zero_glo=True)[0][-1]["rgb"]
        c = t_model(tr, zero_glo=False)[0][-1]["rgb"]
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


def test_embeddings_init_like_flax_embed():
    """Flax `Embed`'s default draws N(0, 1 / features) for `glo`; exposure
    offsets start at zero. Distributions compared, not values."""
    params = dict(MODEL, num_glo_embeddings=1000, num_glo_features=16)
    t_model = t_build("mipnerf360", **params, generator=torch.Generator().manual_seed(0))
    glo = t_model.glo.weight.detach().numpy()
    shapes = jax.eval_shape(lambda k: j_build("mipnerf360", **params).init(
        k, rng=None, rays=j_rays.dummy_rays((8,)), zero_glo=False), jax.random.PRNGKey(0))
    assert glo.shape == shapes["params"]["glo"]["embedding"].shape
    flax_glo = np.asarray(default_embed_init(jax.random.PRNGKey(2), glo.shape))
    for x in (glo, flax_glo):
        assert abs(x.mean()) < 0.01 and abs(x.std() - 0.25) < 0.01
    assert np.all(t_model.exposure_scaling.weight.detach().numpy() == 0)


def test_clip_groups_and_weight_decay_take_the_embeddings():
    config = t_load_config("configs/kitti_mipnerf360.json", [
        "grad_max_norm=1.0", "grad_max_val=0", 'weight_decay_mults={"glo": 0.5}'])
    model = t_build("mipnerf360", **MODEL)
    assert [n for n, _ in model.named_children()] == ["nerf_mlp", "prop_mlp", "glo",
                                                       "exposure_scaling"]
    for p in model.parameters():
        p.grad = torch.full_like(p, 3.0)
    t_step.clip_gradients(model, config)
    for _, child in model.named_children():
        norm = t_step.global_norm([p.grad for p in child.parameters()])
        assert abs(float(norm) - 1.0) < 1e-5
    (mult, params), = t_step._decayed_params(config, model)
    assert mult == 0.5 and params == [model.glo.weight]


# -- the train step -----------------------------------------------------------

FLAGSHIP = "configs/kitti_mipnerf360.json"
# At the first step (train_frac 0) every level resamples uniformly; where one
# level's count divides another's (16 and 8), their edges coincide in exact
# arithmetic and the interlevel envelope's bracket at each tie is decided by
# the last bit of two float32 computations (0.3% of that term seen at 12 and
# 6). Counts with no common divisor leave no interior tie.
STEP_MODEL = dict(MODEL, num_prop_samples=11, num_nerf_samples=7,
                  nerf_mlp_params=dict(NERF, net_width=16, bottleneck_width=8,
                                       net_width_viewdirs=8))
OPTIONS = [
    "dataset=synthetic", "batch_size=32", "max_steps=3", "lr_delay_steps=0",
    "exp_dir=unused", "data_loss_type=rawnerf",
    # The Ref-NeRF mults of multinerf's configs/blender_refnerf.gin.
    "orientation_loss_mult=0.1", "orientation_coarse_loss_mult=0.01",
    "orientation_loss_target=normals_pred", "predicted_normal_loss_mult=3e-4",
    "predicted_normal_coarse_loss_mult=3e-5",
]


def _configs(extra=()):
    overrides = OPTIONS + [f"model_params={json.dumps(STEP_MODEL)}", *extra]
    return j_load_config(FLAGSHIP, overrides), t_load_config(FLAGSHIP, overrides)


def _flat_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def steps():
    """Three steps of each package from the same Flax weights (made with
    zero_glo=False), deterministic sampling."""
    config_j, config_t = _configs(["randomized=false"])
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=32, seed=1, n_images=N_CAMS)
    batches = [dataset.sample_batch() for _ in range(3)]
    mesh = parallel.make_mesh(jax.devices()[:1])
    model_j = j_step.build_model(config_j)
    params0 = jax.device_get(jax.jit(lambda k: model_j.init(
        k, rng=None, rays=j_rays.dummy_rays((8,)), train_frac=1.0, compute_extras=False,
        zero_glo=False))(jax.random.PRNGKey(0)))
    state = TrainState.create(apply_fn=model_j.apply, params=params0,
                              tx=j_step.make_optimizer(config_j)[0])
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    as_port = lambda tree: _flat_params(convert.params_from_flax(jax.device_get(tree),
                                                                 t_step.build_model(config_t)))
    stats_j, params_j = [], []
    for i, b in enumerate(batches):
        state, stats = step_j(state, parallel.shard_batch(b, mesh), jax.random.PRNGKey(i),
                              i / config_j.max_steps)
        stats_j.append(jax.device_get(stats))
        params_j.append(as_port(state.params))

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    stats_t, params_t = [], []
    for i, b in enumerate(batches):
        stats_t.append(step_t(_to_torch(b), i, i / config_t.max_steps, None))
        params_t.append(_flat_params(model_t))

    test_batch = j_datasets.SyntheticDataset("test", seed=2).image_batch(1)
    render_j = j_step.render_image(j_step.make_render_fn(config_j, model_j, mesh), params0,
                                   test_batch, mesh, chunk_size=40)
    model_r = convert.params_from_flax(params0, t_step.build_model(config_t))
    render_t = t_step.render_image(model_r, _to_torch(test_batch), chunk_size=40, device="cpu")
    return stats_j, params_j, stats_t, params_t, render_j, render_t


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


@pytest.mark.parametrize("n_steps", [1, 2, 3])
def test_steps_with_every_option_match(steps, n_steps):
    stats_j, params_j, stats_t, params_t, _, _ = steps
    sj, st = stats_j[n_steps - 1], stats_t[n_steps - 1]
    assert {"orientation", "predicted_normals", "data"} <= set(st["loss_terms"])
    assert set(st["loss_terms"]) == set(sj["loss_terms"])
    for k, v in sj["loss_terms"].items():
        np.testing.assert_allclose(float(st["loss_terms"][k]), float(v), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(st["grad_norm"]), float(sj["grad_norm"]), rtol=1e-4)
    pj, pt = params_j[n_steps - 1], params_t[n_steps - 1]
    assert {"glo.weight", "exposure_scaling.weight", "nerf_mlp.normal_head.weight",
            "nerf_mlp.roughness_head.weight", "prop_mlp.normal_head.weight"} <= set(pt)
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=1e-5, rtol=1e-5, err_msg=name)


def test_render_with_density_normals_matches(steps):
    *_, render_j, render_t = steps
    assert set(render_t) == {k for k in render_j if not k.startswith("ray_")}
    assert {"normals", "normals_pred", "roughness"} <= set(render_t)
    for key in render_t:
        tol = dict(rtol=1e-4) if key.startswith(("distance", "depth")) else dict(
            atol=5e-5 if key.startswith("normals") else 2e-5)
        np.testing.assert_allclose(render_t[key], np.asarray(render_j[key]), err_msg=key, **tol)


def test_reference_init_state_leaves_the_embeddings_out():
    """The reference's `init_state` initializes with zero_glo=True, so its
    parameter tree has no `glo` or `exposure_scaling`, and its train step
    (zero_glo=False) then fails to find them; the port's model owns them
    from construction and trains with them (the steps above)."""
    config_j, config_t = _configs(["randomized=false"])
    model_j = j_step.build_model(config_j)
    shapes = jax.eval_shape(lambda k: j_step.init_state(config_j, k)[1], jax.random.PRNGKey(0))
    assert set(shapes.params["params"]) == {"nerf_mlp", "prop_mlp"}
    # The step fails while tracing, before any value matters: zeros will do.
    state = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=32, seed=1)
    mesh = parallel.make_mesh(jax.devices()[:1])
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    with pytest.raises(ScopeParamNotFoundError, match="glo"):
        step_j(state, parallel.shard_batch(dataset.sample_batch(), mesh),
               jax.random.PRNGKey(0), 0.0)
    names = {n for n, _ in t_step.build_model(config_t).named_parameters()}
    assert {"glo.weight", "exposure_scaling.weight"} <= names


def _remat_run(remat):
    _, config = _configs(["randomized=true", f"remat={remat}"])
    config = config.replace(model_params=dict(
        config.model_params, nerf_mlp_params=dict(NERF, net_width=16, bottleneck_width=8,
                                                  net_width_viewdirs=8, density_noise=0.1,
                                                  bottleneck_noise=0.1)))
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    dataset = t_datasets.SyntheticDataset("train", global_batch_size=32, n_images=N_CAMS,
                                          height=12, width=16, seed=3)
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    step = t_step.make_train_step(config, model, optimizer, lr_fn,
                                  cameras=dataset.cameras_on("cpu"), camtype=dataset.camtype)
    gen = torch.Generator().manual_seed(5)
    stats = [step(dataset.sample_batch(), i, 0.3 + 0.1 * i, gen) for i in range(2)]
    return stats, _flat_params(model), gen.get_state()


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_with_density_normals_matches_none(remat):
    """The normal's gradient runs inside the checkpointed forward and again
    in its recompute, with the same jitter and noise draws."""
    base_stats, base_params, base_gen = _remat_run("none")
    stats, params, gen = _remat_run(remat)
    for s, b in zip(stats, base_stats):
        assert set(s["loss_terms"]) == set(b["loss_terms"])
        for k in b["loss_terms"]:
            np.testing.assert_allclose(float(s["loss_terms"][k]), float(b["loss_terms"][k]),
                                       rtol=1e-6, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(float(s["grad_norm"]), float(b["grad_norm"]), rtol=1e-6)
    for name, p in base_params.items():
        np.testing.assert_allclose(params[name], p, rtol=1e-6, atol=1e-9, err_msg=name)
    assert torch.equal(gen, base_gen)
