"""The port's iterative NGP eval renderer (`HashGridModel.render_eval`, with
`calc_dt`) against the reference package's on the CPU: the same Flax
weights, a partly occupied grid, rays that end opaque (early termination),
rays whose candidate window holds more occupied cells than a round renders
(a truncated window) and rays that miss the scene's cube. rgb, depth and
acc agree to 1e-5; `samples_per_ray` and `rounds` exactly. `render_image`
takes the iterative renderer when `ngp_eval_renderer="iterative"`."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.models import build as t_build
from outdoor_nerf_depth_torch.ops import occupancy as t_occ
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.models.ngp import HashGridModel as JHashGridModel
from outdoor_nerf_depth_tpu.ops import occupancy as j_occ
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

FIELD = dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
             hidden_width=16, geo_features=7)
# Rounds of 16 candidates, 4 of them rendered: a window of an occupied
# region holds more than 4 occupied candidates and is revisited.
MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16,
             eval_samples_per_round=4, eval_candidates_per_round=16,
             eval_max_total_samples=64, eval_early_stop_eps=1e-3, field_params=FIELD)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _grid(seed=0):
    """[1, 16^3]: a third of the cells occupied."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.5, 2.0, (1, 16**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.67] = 0.0
    return grid


def _rays(n=48, seed=7):
    """Rays from inside the cube, and the last 8 from outside pointing away."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    o = rng.uniform(-0.25, 0.25, (n, 3))
    o[-8:] = 2.0 * np.sign(d[-8:])  # outside, moving away: they miss the cube
    fields = dict(origins=o, directions=d, viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  radii=np.full((n, 1), 1e-3), imageplane=np.zeros((n, 2)),
                  lossmult=np.ones((n, 1)), near=np.full((n, 1), 0.01),
                  far=np.full((n, 1), 30.0))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields["cam_idx"] = np.zeros((n, 1), np.int32)
    return (j_rays.Rays(**{k: jnp.asarray(v) for k, v in fields.items()}),
            t_rays.Rays(**{k: torch.from_numpy(v) for k, v in fields.items()}))


def _weights(bias):
    """Flax weights with the density bias raised by `bias`: an opaque field
    whose rays terminate early, or a dim one whose rays run to the end."""
    j_model = j_build("ngp", **MODEL)
    variables = jax.device_get(j_model.init(
        jax.random.PRNGKey(0), rng=None, rays=j_rays.dummy_rays((8,)), train_frac=1.0,
        compute_extras=False))
    b = np.array(variables["params"]["field"]["sigma_out"]["bias"])
    b[0] += bias
    variables["params"]["field"]["sigma_out"]["bias"] = b
    return j_model, variables


@pytest.fixture(scope="module", params=[5.0, 0.0], ids=["opaque", "dim"])
def renders(request):
    j_model, variables = _weights(request.param)
    jr, tr = _rays()
    grid = _grid()
    want = jax.jit(lambda v, r, g: j_model.apply(v, r, g, method=JHashGridModel.render_eval))(
        variables, jr, jnp.asarray(grid))
    model = convert.params_from_flax(variables, t_build("ngp", **MODEL))
    got = model.render_eval(tr, torch.from_numpy(grid))
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}, \
        model, tr, grid


def test_render_eval_matches(renders):
    want, got, *_ = renders
    assert set(got) == set(want)
    for key in ("rgb", "depth", "distance_mean", "acc"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL, err_msg=key)
    np.testing.assert_array_equal(got["samples_per_ray"], want["samples_per_ray"])
    np.testing.assert_array_equal(got["rounds"], want["rounds"])


def test_render_eval_covers_its_cases(renders, request):
    want, got, model, tr, grid = renders
    # Rays that miss the cube render nothing and the background.
    assert np.all(got["samples_per_ray"][-8:] == 0) and np.all(got["acc"][-8:] == 0)
    inside = got["samples_per_ray"][:-8] > 0
    assert inside.mean() > 0.75  # a few rays cross no occupied cell
    # A truncated first window: more occupied candidates than rendered slots.
    t_near, t_far, hit = t_occ.intersect_aabb(tr.origins, tr.viewdirs, model.e_max, 0.01)
    dt = t_occ.calc_dt(t_near, 0.0, MODEL["eval_max_total_samples"], 16, model.e_max)
    mids = t_near[:, None] + (torch.arange(16) + 0.5) * dt[:, None]
    occupied = t_occ.lookup(torch.from_numpy(grid), tr.origins[:, None] + mids[..., None]
                            * tr.viewdirs[:, None], 0.5, 0.01) & hit[:, None]
    assert int(occupied.sum(-1).max()) > MODEL["eval_samples_per_round"]
    rounds = int(got["rounds"][0])
    assert rounds < 32  # the default limit, 2 * 64 / 4, is never reached
    if "opaque" in request.node.callspec.id:
        # Early termination: every ray that samples turns opaque.
        assert np.all(got["acc"][:-8][inside] > 1 - 2e-3)
    else:
        # Dim rays run on until they leave the cube.
        assert np.max(got["acc"]) < 0.5 and rounds > 2


def test_calc_dt_matches_exactly():
    t = np.concatenate([np.linspace(0.0, 40.0, 997), [1e-6, 1e6]]).astype(np.float32)
    for factor in (0.0, 1.0 / 256.0):
        want = np.asarray(j_occ.calc_dt(jnp.asarray(t), factor, 1024, 128, 8.0))
        got = t_occ.calc_dt(torch.from_numpy(t), factor, 1024, 128, 8.0).numpy()
        np.testing.assert_array_equal(got, want)


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


def test_render_image_dispatches_to_the_iterative_renderer():
    overrides = ["dataset=synthetic", "exp_dir=unused", "ngp_eval_renderer=iterative",
                 "model_params=" + json.dumps(MODEL)]
    config_j = j_load_config("configs/kitti_ngp.json", overrides)
    config_t = t_load_config("configs/kitti_ngp.json", overrides)
    mesh = parallel.make_mesh(jax.devices()[:1])
    model_j, variables = _weights(5.0)
    batch = j_datasets.SyntheticDataset("test", seed=2).image_batch(1)
    grid = _grid(1)
    want = j_step.render_image(j_step.make_render_fn(config_j, model_j, mesh), variables, batch,
                               mesh, chunk_size=40, aux=jnp.asarray(grid))
    model = convert.params_from_flax(variables, t_step.build_model(config_t))
    model.occupancy.copy_(torch.from_numpy(grid))
    got = t_step.render_image(model, _to_torch(batch), chunk_size=40, device="cpu",
                              ngp_eval_renderer=config_t.ngp_eval_renderer)
    dense = t_step.render_image(model, _to_torch(batch), chunk_size=40, device="cpu")
    assert "rounds" in got and "rounds" not in dense
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=TOL, rtol=TOL,
                                   err_msg=key)
