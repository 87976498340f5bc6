"""The rest of the port's Instant-NGP options against the reference package
on the CPU: Morton codes, the visibility cull, the HDR field (tonemapper,
radiance map, exposure) through the train renderer and `render_eval`,
per-image extrinsics refinement (`optimize_ext`) with its gradients and
three clipped train steps, and checkpoints across hash layouts.

Flax variables come from `jax.eval_shape` and numpy (as
`tests/test_torch_depth_priors.py:_variables` makes them), so no `init` is
compiled; JAX calls are compiled once, under
`jax.default_matmul_precision("highest")`."""

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
from outdoor_nerf_depth_torch.train import checkpoints as t_ckpt
from outdoor_nerf_depth_torch.train import loop as t_loop
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

CONFIG = "configs/kitti_ngp.json"
TABLE_MOMENT_RTOL = 2e-6
# tests/test_torch_ngp.py's model: two levels, one dense (res 4) and one
# hashed (res 16 in a 2^10 table).
FIELD = dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
             hidden_width=16, geo_features=7, grad_mode="sorted")
MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16)
HDR = dict(MODEL, field_params=dict(FIELD, rgb_activation="none", tonemap_width=8))
EXT = dict(MODEL, optimize_ext=True, num_images=8, field_params=FIELD)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


# ---- Morton codes and the visibility cull

def test_morton_golden_values_and_round_trip():
    coords = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1], [2, 0, 0]])
    np.testing.assert_array_equal(t_occ.morton3d(torch.from_numpy(coords)).numpy(),
                                  [1, 2, 4, 7, 8])
    rng = np.random.default_rng(4)
    coords = rng.integers(0, 1024, (256, 3)).astype(np.int32)
    codes = t_occ.morton3d(torch.from_numpy(coords))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_occ.morton3d(jnp.asarray(coords))))
    np.testing.assert_array_equal(t_occ.morton3d_invert(codes).numpy(), coords)


def test_morton_wraps_as_uint32_does():
    """Coordinates past 10 bits and every int32 code: the reference's uint32
    products and shifts wrap; the int64 arithmetic masked to 32 bits gives
    the same bits."""
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 2**31 - 1, (4096, 3)).astype(np.int32)
    np.testing.assert_array_equal(t_occ.morton3d(torch.from_numpy(coords)).numpy(),
                                  np.asarray(j_occ.morton3d(jnp.asarray(coords))))
    codes = rng.integers(-2**31, 2**31 - 1, 4096).astype(np.int32)
    codes[:2] = [-1, -2**31]
    np.testing.assert_array_equal(t_occ.morton3d_invert(torch.from_numpy(codes)).numpy(),
                                  np.asarray(j_occ.morton3d_invert(jnp.asarray(codes))))


def _cameras(n=5, seed=3):
    """OpenGL camera-to-worlds on a sphere of radius 1.2 looking at the origin."""
    rng = np.random.default_rng(seed)
    c2w = []
    for _ in range(n):
        pos = rng.normal(size=3)
        pos *= 1.2 / np.linalg.norm(pos)
        back = pos / np.linalg.norm(pos)  # +z points away from the target
        right = np.cross([0.0, 0.0, 1.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w.append(np.stack([right, up, back, pos], axis=1))
    return np.asarray(c2w, np.float32)


@pytest.mark.parametrize("chunk", [262_144, 1000])
def test_mark_invisible_cells_matches_exactly(chunk):
    """Two cascades of 16^3 cells, five cameras with a narrow view (focal 60
    px on 32x24 images: 31% and 64% of the cells culled); chunks of 1000
    cells as well."""
    grid = np.random.default_rng(0).uniform(0.0, 1.0, (2, 16**3)).astype(np.float32)
    grid[0, :7] = -1.0  # culled before: stays culled
    c2w = _cameras()
    k = np.array([[60.0, 0.0, 16.0], [0.0, 60.0, 12.0], [0.0, 0.0, 1.0]], np.float32)
    want = np.asarray(j_occ.mark_invisible_cells(jnp.asarray(grid), jnp.asarray(c2w),
                                                 jnp.asarray(k), 32, 24, scale=1.0))
    got = t_occ.mark_invisible_cells(torch.from_numpy(grid), torch.from_numpy(c2w),
                                     torch.from_numpy(k), 32, 24, scale=1.0, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    culled = (want == -1.0).mean(axis=-1)
    assert np.all(culled > 0.2) and np.all(culled < 0.9), culled
    np.testing.assert_array_equal(grid[want != -1.0], got.numpy()[want != -1.0])
    # A refresh keeps the culled cells.
    fresh = t_occ.update_grid(got, lambda p: torch.full(p.shape[:-1], 5.0), scale=1.0,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(fresh == -1.0, got == -1.0)


# ---- the HDR field and extrinsics refinement

def _variables(model, seed=1):
    """Random Flax variables of the NGP model: kernels at Flax's fan-in
    scale, small biases and pose deltas, the table at 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: model.init(k, rng=None, rays=j_rays.dummy_rays((8,)),
                                                 train_frac=1.0, compute_extras=False),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            val = rng.normal(size=shape) / np.sqrt(shape[0])
        elif name == "table":
            val = rng.uniform(-0.1, 0.1, shape)
        else:
            val = 0.05 * rng.normal(size=shape)
        return val.astype(np.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(fill, shapes))


def _rays(n=24, seed=7, exposure=None, n_images=8):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    fields = dict(
        origins=rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32), directions=d,
        viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3, np.float32), imageplane=np.zeros((n, 2), np.float32),
        lossmult=np.ones((n, 1), np.float32), near=np.full((n, 1), 0.01, np.float32),
        far=np.full((n, 1), 30.0, np.float32),
        cam_idx=rng.integers(0, n_images, (n, 1)).astype(np.int32),
    )
    if exposure is not None:
        fields["exposure_values"] = np.full((n, 1), exposure, np.float32)
    return (j_rays.Rays(**{k: jnp.asarray(v) for k, v in fields.items()}),
            t_rays.Rays(**{k: torch.from_numpy(v) for k, v in fields.items()}))


def _grid(seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.0, 2.0, (1, 16**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.6] = 0.0
    return grid


def _models(params, variables):
    return j_build("ngp", **params), convert.params_from_flax(variables, t_build("ngp", **params))


def _assert_renders(t_out, j_out, keys=("rgb", "acc", "depth")):
    for key in keys:
        np.testing.assert_allclose(t_out[key].detach().numpy(), np.asarray(j_out[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def hdr_vars():
    return _variables(j_build("ngp", **HDR))


def test_params_from_flax_takes_the_tonemappers_and_pose_deltas(hdr_vars):
    tree = hdr_vars["params"]
    assert {f"tonemap_{k}{i}" for k in ("hidden", "out") for i in range(3)} <= set(tree["field"])
    model = convert.params_from_flax(hdr_vars, t_build("ngp", **HDR))
    np.testing.assert_array_equal(model.field.tonemap_hidden1.weight.detach().numpy(),
                                  tree["field"]["tonemap_hidden1"]["kernel"].T)
    ext = _variables(j_build("ngp", **EXT))
    assert ext["params"]["pose_dR"]["embedding"].shape == (8, 3)
    model = convert.params_from_flax(ext, t_build("ngp", **EXT))
    np.testing.assert_array_equal(model.pose_dT.weight.detach().numpy(),
                                  ext["params"]["pose_dT"]["embedding"])
    fresh = t_build("ngp", **EXT)
    assert torch.all(fresh.pose_dR.weight == 0) and torch.all(fresh.pose_dT.weight == 0)


@pytest.mark.parametrize("budget", [0, 8])
@pytest.mark.parametrize("exposure", [None, 1.0, 4.0])
def test_hdr_forward_matches(hdr_vars, exposure, budget):
    """The tonemapped render with and without a per-ray exposure, through
    the dense path and the batch-compacted one."""
    params = dict(HDR, sample_budget=budget)
    j_model, t_model = _models(params, hdr_vars)
    jr, tr = _rays(exposure=exposure)
    grid = _grid()
    j_out, _ = jax.jit(lambda v, r, g: j_model.apply(v, None, r, occupancy=g))(
        hdr_vars, jr, jnp.asarray(grid))
    with torch.no_grad():
        t_out, _ = t_model(tr, occupancy=torch.from_numpy(grid))
    _assert_renders(t_out[0], j_out[0])
    assert float(t_out[0]["acc"].max()) > 0.1


def test_exposure_changes_the_tonemapped_colour(hdr_vars):
    _, t_model = _models(HDR, hdr_vars)
    grid = torch.from_numpy(_grid())
    with torch.no_grad():
        dark = t_model(_rays(exposure=0.25)[1], occupancy=grid)[0][0]["rgb"]
        bright = t_model(_rays(exposure=4.0)[1], occupancy=grid)[0][0]["rgb"]
        unit = t_model(_rays(exposure=1.0)[1], occupancy=grid)[0][0]["rgb"]
        none = t_model(_rays()[1], occupancy=grid)[0][0]["rgb"]
    assert float((bright - dark).abs().max()) > 1e-3
    torch.testing.assert_close(unit, none, rtol=0, atol=0)


def test_output_radiance_matches(hdr_vars):
    params = dict(HDR, output_radiance=True)
    j_model, t_model = _models(params, hdr_vars)
    jr, tr = _rays(exposure=2.0)
    grid = _grid()
    j_out, _ = jax.jit(lambda v, r, g: j_model.apply(v, None, r, occupancy=g))(
        hdr_vars, jr, jnp.asarray(grid))
    with torch.no_grad():
        t_out, _ = t_model(tr, occupancy=torch.from_numpy(grid))
        tonemapped = _models(HDR, hdr_vars)[1](tr, occupancy=torch.from_numpy(grid))[0][0]
    _assert_renders(t_out[0], j_out[0])
    assert float((t_out[0]["rgb"] - tonemapped["rgb"]).abs().max()) > 1e-3


@pytest.mark.parametrize("params", ["hdr", "ext"])
def test_render_eval_matches(hdr_vars, params):
    """The iterative renderer with exposure (HDR) and with refined rays."""
    params, variables = (HDR, hdr_vars) if params == "hdr" else (EXT, _variables(
        j_build("ngp", **EXT)))
    j_model, t_model = _models(params, variables)
    jr, tr = _rays(exposure=2.0 if params is HDR else None)
    grid = _grid()
    j_out = jax.jit(lambda v, r, g: j_model.apply(v, r, g, method=JHashGridModel.render_eval))(
        variables, jr, jnp.asarray(grid))
    t_out = t_model.render_eval(tr, torch.from_numpy(grid))
    _assert_renders(t_out, j_out)
    for key in ("samples_per_ray", "rounds"):
        np.testing.assert_array_equal(t_out[key].numpy(), np.asarray(j_out[key]), key)


@pytest.mark.parametrize("deltas", ["zero", "nonzero"])
def test_refined_rays_match(deltas):
    variables = _variables(j_build("ngp", **EXT))
    if deltas == "zero":
        variables["params"]["pose_dR"]["embedding"][:] = 0.0
        variables["params"]["pose_dT"]["embedding"][:] = 0.0
    j_model, t_model = _models(EXT, variables)
    jr, tr = _rays()
    want = j_model.apply(variables, jr, method=JHashGridModel._refine_rays)
    with torch.no_grad():
        got = t_model.refine_rays(tr)
    for name in ("origins", "directions", "viewdirs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    moved = float((got.directions - tr.directions).abs().max())
    assert (moved == 0.0) if deltas == "zero" else (moved > 1e-3)
    off = t_build("ngp", **MODEL)
    assert off.refine_rays(tr) is tr


@pytest.mark.parametrize("deltas", ["zero", "nonzero"])
def test_pose_gradients_match(deltas):
    """d(sum(rgb * g + depth))/d(pose_dR, pose_dT), through marching, the
    hash encoding's position gradient and compositing."""
    variables = _variables(j_build("ngp", **EXT))
    if deltas == "zero":
        variables["params"]["pose_dR"]["embedding"][:] = 0.0
        variables["params"]["pose_dT"]["embedding"][:] = 0.0
    j_model, t_model = _models(EXT, variables)
    jr, tr = _rays()
    grid = _grid()
    g = np.random.default_rng(9).normal(size=(24, 3)).astype(np.float32)

    def loss(params):
        out, _ = j_model.apply({"params": params}, None, jr, occupancy=jnp.asarray(grid))
        return jnp.sum(out[0]["rgb"] * g) + jnp.sum(out[0]["depth"])

    want = jax.jit(jax.grad(loss))(variables["params"])
    out, _ = t_model(tr, occupancy=torch.from_numpy(grid))
    (torch.sum(out[0]["rgb"] * torch.from_numpy(g)) + torch.sum(out[0]["depth"])).backward()
    for name, attr in (("pose_dR", t_model.pose_dR), ("pose_dT", t_model.pose_dT)):
        w = np.asarray(want[name]["embedding"])
        assert np.abs(w).max() > 1e-3, name
        np.testing.assert_allclose(attr.weight.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _flat_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    a = np.asarray(obj)
    return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a.copy())


def test_three_clipped_steps_with_optimize_ext_and_hdr_match():
    """Three train steps of the HDR field with extrinsics refinement, with
    per-top-level-module value and norm clipping (pose_dR and pose_dT are
    groups of their own, as Flax's top-level params are), on the oct layout,
    whose table gradient rounds nothing to bf16."""
    params = dict(MODEL, optimize_ext=True, num_images=8, sample_budget=8,
                  field_params=dict(FIELD, rgb_activation="none", tonemap_width=8,
                                    hash_layout="oct"))
    args = ["dataset=synthetic", "batch_size=64", "max_steps=3", "randomized=false",
            "exp_dir=unused", "grad_max_val=0.05", "grad_max_norm=0.02",
            "model_params=" + json.dumps(params)]
    config_j, config_t = j_load_config(CONFIG, args), t_load_config(CONFIG, args)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batches = [dataset.sample_batch() for _ in range(3)]
    grid = _grid(1)
    mesh = parallel.make_mesh(jax.devices()[:1])
    model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
    variables = _variables(model_j, seed=2)
    state = state.replace(params=variables,
                          opt_state=j_step.make_optimizer(config_j)[0].init(variables))
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    model_t = convert.params_from_flax(variables, t_step.build_model(config_t))
    model_t.occupancy.copy_(torch.from_numpy(grid))
    assert [n for n, _ in model_t.named_children()] == ["field", "pose_dR", "pose_dT"]
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    as_port = lambda tree: _flat_params(convert.params_from_flax(jax.device_get(tree),
                                                                 t_step.build_model(config_t)))
    table = model_t.field.encoder.table
    near_zero = np.zeros(table.shape, bool)
    for i, b in enumerate(batches):
        state, stats_j = step_j(state, parallel.shard_batch(b, mesh), jax.random.PRNGKey(i),
                                i / 3, jnp.asarray(grid))
        stats_t = step_t(_to_torch(b), i, i / 3, None)
        np.testing.assert_allclose(float(stats_t["loss"]), float(stats_j["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]),
                                   rtol=1e-4)
        # The table's clipped gradient, through Adam's moments: exp_avg
        # against mu and exp_avg_sq against nu, at TABLE_MOMENT_RTOL of the
        # largest entry (the oct gradient's row sums are differences of f32
        # prefix sums, a few ulps of the largest prefix apart).
        for key, tree in (("exp_avg", state.opt_state[0].mu), ("exp_avg_sq", state.opt_state[0].nu)):
            want = as_port(tree)["field.encoder.table"]
            atol = TABLE_MOMENT_RTOL * np.abs(want).max()
            np.testing.assert_allclose(optimizer.state[table][key].numpy(), want, rtol=0,
                                       atol=atol, err_msg=f"step {i} {key}")
            if key == "exp_avg":
                near_zero |= (np.abs(want) > 0) & (np.abs(want) <= atol)
    params_j = _flat_params(convert.params_from_flax(jax.device_get(state.params),
                                                     t_step.build_model(config_t)))
    params_t = _flat_params(model_t)
    assert np.abs(params_t["pose_dR.weight"] - variables["params"]["pose_dR"]["embedding"]).max() > 1e-3
    for name in params_j:
        # Adam moves a weight by lr m / (sqrt(v) + eps) a step, less than lr.
        # On a table entry whose first moment was within its tolerance of 0
        # at some step, a rounding of g changes that ratio by a large share
        # of lr, so those entries are held at the three steps' 3 lr; every
        # other entry and every other parameter, the pose deltas included,
        # at 1e-5.
        atol = np.full(params_j[name].shape, 1e-5)
        if name == "field.encoder.table":
            atol[near_zero] = 3 * config_t.lr_init
            print(f"{int(near_zero.sum())} of {near_zero.size} table entries held at 3 lr")
            assert near_zero.mean() < 0.1
        err = np.abs(params_t[name] - params_j[name]) - 1e-5 * np.abs(params_j[name])
        assert (err <= atol).all(), (name, float((err - atol).max()))


# ---- checkpoints across hash layouts

def _small_config(tmp_path, layout, steps=1):
    field = dict(FIELD, hash_layout=layout)
    return t_load_config(CONFIG, [
        "dataset=synthetic", "batch_size=64", f"max_steps={steps}", "randomized=false",
        f"exp_dir={tmp_path}", "checkpoint_every=1", "print_every=1",
        "model_params=" + json.dumps(dict(MODEL, sample_budget=8, field_params=field))])


@pytest.mark.parametrize("layout", ["oct", "quad", "corner"])
def test_checkpoints_across_layouts(tmp_path, layout):
    """An osplit checkpoint restores into oct and quad (one linear hash) and
    is refused by corner (another hash function), by resume and by
    load_checkpoint alike."""
    osplit, _ = t_loop.train(_small_config(tmp_path, "osplit"), device="cpu",
                             log_fn=lambda line: None)
    assert t_ckpt.read_model_meta(str(tmp_path / "checkpoints"))["hash_function"] == "linear"
    other = _small_config(tmp_path, layout)
    if layout == "corner":
        assert t_step.checkpoint_meta(other, t_step.build_model(other))["hash_function"] == "corner"
        with pytest.raises(ValueError, match="hash_function"):
            t_step.load_checkpoint(other)
        with pytest.raises(ValueError, match="hash_function"):
            t_loop.train(_small_config(tmp_path, layout, steps=2), device="cpu",
                         log_fn=lambda line: None)
        return
    model, step = t_step.load_checkpoint(other)
    assert step == 1 and model.field.encoder.layout == layout
    torch.testing.assert_close(model.field.encoder.table, osplit.field.encoder.table)
    resumed, _ = t_loop.train(_small_config(tmp_path, layout, steps=2), device="cpu",
                              log_fn=lambda line: None)
    assert resumed.field.encoder.layout == layout
