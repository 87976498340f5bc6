"""The port's NeRF++ backend against the reference package on the CPU: the
point MLP, both cascade levels of the inverted-sphere model (with and
without the reference's own jitter and resampling draws, with and without
autoexposure), three train steps, the chunked renderer, the parameter
conversion, and the CLI on the KITTI fixture's NeRF++ layout. The same Flax
weights go into the port through `params_from_flax`."""

import contextlib
import dataclasses
import json

import jax
import numpy as np
from flax.training.train_state import TrainState
import pytest
import torch

from outdoor_nerf_depth_torch import __main__ as t_cli
from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.models import build as t_build
from outdoor_nerf_depth_torch.models.mlps import PointFieldMLP as TPointFieldMLP
from outdoor_nerf_depth_torch.tools import make_kitti_fixture as t_fixture
from outdoor_nerf_depth_torch.train import losses as t_losses
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.models.mlps import PointFieldMLP as JPointFieldMLP
from outdoor_nerf_depth_tpu.train import losses as j_losses
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

CONFIG = "configs/kitti_nerfpp.json"
# The reference's own NeRF++ test sizes; net_depth 6 also runs the skip
# after layer 4.
SMALL = dict(cascade_samples=(6, 6), net_depth=2, net_width=16, pos_degrees=4, view_degrees=2)
MODELS = {
    "small": SMALL,
    "skip_autoexposure": dict(SMALL, cascade_samples=(8, 8), net_depth=6,
                              optimize_autoexposure=True, num_images=5),
}
# The config's losses, masks and clip, with the autoexposure embedding and
# its regularizer on (the synthetic scene has 4 images).
STEP_OVERRIDES = [
    "dataset=synthetic", "batch_size=64", "max_steps=3", "lr_delay_steps=0", "exp_dir=unused",
    "autoexpo_loss_mult=0.1",
    "model_params=" + json.dumps(dict(SMALL, optimize_autoexposure=True, num_images=4)),
]
N_RAYS = 24


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _rays(n=N_RAYS, seed=0, num_images=5):
    """Camera-like rays from inside the unit sphere, per-ray near bounds."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3))
    d = rng.normal(size=(n, 3)) * rng.uniform(0.7, 1.5, (n, 1))
    fields = dict(
        origins=o, directions=d, viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3), imageplane=np.zeros((n, 2)), lossmult=np.ones((n, 1)),
        near=rng.uniform(1e-4, 0.05, (n, 1)), far=np.full((n, 1), 2.0),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields["cam_idx"] = rng.integers(0, num_images, (n, 1)).astype(np.int32)
    return (j_rays.Rays(**{k: jax.numpy.asarray(v) for k, v in fields.items()}),
            t_rays.Rays(**{k: torch.from_numpy(v) for k, v in fields.items()}))


def _jax_draws(key, n_rays, cascade):
    """The reference model's uniform draws in the order the port makes them:
    per level, fg then bg (level 0: stratified jitter; later levels: the
    inverse-CDF samples' jitter, before its scaling)."""
    draws = []
    for n in cascade:
        sub, key = jax.random.split(key)
        for k in jax.random.split(sub):
            draws.append(np.asarray(jax.random.uniform(k, (n_rays, n))))
    return draws


@contextlib.contextmanager
def _fed(draws):
    """torch.rand replaced by `draws`, handed out in order (shape-checked)."""
    queue, real = list(draws), torch.rand

    def rand(shape, generator=None, dtype=None, device=None):
        assert generator is not None
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (shape, want.shape)
        return torch.from_numpy(np.array(want)).to(dtype=dtype or torch.float32, device=device)

    torch.rand = rand
    try:
        yield
    finally:
        torch.rand = real
    assert not queue, f"{len(queue)} draws left unused"


def _init(j_model, j_rays_):
    return jax.jit(lambda k: j_model.init(k, rng=None, rays=j_rays_, train_frac=1.0,
                                          compute_extras=False))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("net_depth", [2, 6])
@pytest.mark.parametrize("input_dim", [3, 4])
@pytest.mark.parametrize("per_ray_dirs", [True, False])
def test_point_field_mlp_matches(net_depth, input_dim, per_ray_dirs):
    rng = np.random.default_rng(net_depth + input_dim)
    pts = rng.uniform(-1, 1, (7, 5, input_dim)).astype(np.float32)
    dirs = rng.normal(size=(7, 3) if per_ray_dirs else (7, 5, 3)).astype(np.float32)
    kw = dict(input_dim=input_dim, net_depth=net_depth, net_width=16, pos_degrees=4,
              view_degrees=2)
    j_mlp = JPointFieldMLP(**kw)
    j_vars = j_mlp.init(jax.random.PRNGKey(1), pts, dirs)
    t_mlp = convert.params_from_flax(jax.device_get(j_vars), TPointFieldMLP(**kw))
    j_sigma, j_rgb = j_mlp.apply(j_vars, pts, dirs)
    with torch.no_grad():
        t_sigma, t_rgb = t_mlp(torch.from_numpy(pts), torch.from_numpy(dirs))
    assert t_sigma.shape == (7, 5) and t_rgb.shape == (7, 5, 3)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(j_sigma), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=1e-6, rtol=1e-6)
    assert (t_sigma >= 0).all()


def test_point_field_mlp_initializes_like_the_reference():
    """Xavier-uniform weights, zero biases, and the Flax layer order."""
    gen = torch.Generator().manual_seed(0)
    mlp = TPointFieldMLP(input_dim=4, net_depth=8, net_width=256, generator=gen)
    assert mlp.flax_dense_names == [f"trunk{i}" for i in range(8)] + [
        "sigma_head", "base", "view", "rgb_head"]
    # 4 * (1 + 2 * 10) = 84 encoding channels; after layer 4 they join the trunk.
    assert mlp.trunk0.in_features == 84 and mlp.trunk5.in_features == 256 + 84
    assert mlp.view.in_features == 256 + 27 and mlp.rgb_head.in_features == 128
    for name in mlp.flax_dense_names:
        layer = getattr(mlp, name)
        bound = np.sqrt(6.0 / (layer.in_features + layer.out_features))
        weight, bias = layer.weight.detach(), layer.bias.detach()
        assert float(weight.abs().max()) <= bound and float(bias.abs().max()) == 0.0


def _compare_levels(t_out, j_out, atol=2e-5):
    (t_render, t_hist), (j_render, j_hist) = t_out, j_out
    assert len(t_render) == len(j_render) == len(t_hist) == len(j_hist)
    for level, (tr, jr) in enumerate(zip(t_render, j_render)):
        assert set(tr) == set(jr), level
        for key in jr:
            np.testing.assert_allclose(tr[key].numpy(), np.asarray(jr[key]), atol=atol, rtol=atol,
                                       err_msg=f"level {level} {key}")
    for level, (th, jh) in enumerate(zip(t_hist, j_hist)):
        assert set(th) == set(jh), level
        for key in jh:
            np.testing.assert_allclose(th[key].numpy(), np.asarray(jh[key]), atol=atol, rtol=atol,
                                       err_msg=f"history {level} {key}")


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("randomized", [False, True])
def test_inverted_sphere_model_levels_match(name, randomized):
    params = MODELS[name]
    jr, tr = _rays()
    j_model = j_build("nerfpp", **params)
    j_vars = _init(j_model, jr)
    t_model = convert.params_from_flax(jax.device_get(j_vars), t_build("nerfpp", **params))
    key = jax.random.PRNGKey(3) if randomized else None
    j_out = jax.jit(lambda v, r: j_model.apply(v, key, r, train_frac=1.0,
                                               compute_extras=True))(j_vars, jr)
    draws = _jax_draws(key, N_RAYS, params["cascade_samples"]) if randomized else []
    with torch.no_grad(), _fed(draws):
        t_out = t_model(tr, train_frac=1.0, compute_extras=True,
                        generator=torch.Generator() if randomized else None)
    _compare_levels(t_out, j_out)
    fine = t_out[0][-1]
    assert fine["fg_weights"].shape == (N_RAYS, sum(params["cascade_samples"]))
    if params.get("optimize_autoexposure"):
        assert set(dict(t_model.named_children())) == {"level0", "level1", "autoexpo0",
                                                       "autoexpo1"}
        np.testing.assert_array_equal(fine["autoexpo_scale"].numpy(), 1.0)


def test_params_from_flax_round_trips_the_full_tree():
    params = MODELS["skip_autoexposure"]
    jr, _ = _rays()
    tree = jax.device_get(_init(j_build("nerfpp", **params), jr))
    rng = np.random.default_rng(0)
    # Every leaf distinct, so a leaf copied into the wrong place shows.
    tree = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
    model = convert.params_from_flax(tree, t_build("nerfpp", **params))
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert len(flat) == len(list(model.parameters()))
    for path, leaf in flat:
        keys = [p.key for p in path]
        module = model
        for k in keys[:-1]:
            if k.startswith("Dense_"):
                k = module.flax_dense_names[int(k.split("_")[1])]
            module = getattr(module, k)
        got = {"kernel": lambda: module.weight.detach().numpy().T,
               "bias": lambda: module.bias.detach().numpy(),
               "embedding": lambda: module.weight.detach().numpy()}[keys[-1]]()
        np.testing.assert_array_equal(got, leaf, err_msg="/".join(keys))


def test_params_from_flax_raises_on_a_mismatch():
    params = MODELS["skip_autoexposure"]
    jr, _ = _rays()
    tree = jax.device_get(_init(j_build("nerfpp", **params), jr))["params"]

    def edited(fn):
        t = jax.tree_util.tree_map(np.array, tree)
        fn(t)
        return t

    cases = {
        "shape": lambda t: t["level1"]["bg_field"]["Dense_3"].update(
            kernel=np.zeros((16, 17), np.float32)),
        "missing": lambda t: t["level0"]["fg_field"].pop("Dense_7"),
        "left over": lambda t: t["level0"]["fg_field"].update(
            Dense_12={"kernel": np.zeros((8, 3), np.float32)}),
        "embedding shape": lambda t: t["autoexpo1"].update(embedding=np.zeros((6, 2), np.float32)),
    }
    for name, fn in cases.items():
        with pytest.raises(ValueError):
            convert.params_from_flax(edited(fn), t_build("nerfpp", **params))
        assert name


def _to_torch(obj):
    """A reference Batch/Rays/Pixels as the port's, as float32/int32 tensors."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


def _flat_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def steps():
    """Three randomized train steps of each package from the same weights on
    the same batches, the port fed the reference's draws; and a render."""
    config_j = j_load_config(CONFIG, STEP_OVERRIDES)
    config_t = t_load_config(CONFIG, STEP_OVERRIDES)
    assert config_t.randomized and config_t.depth_fg_far_mask and config_t.grad_max_norm == 1.0
    assert config_t.data_coarse_loss_mult == 1.0 and config_t.depth_loss_type == "mse"
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batches = [dataset.sample_batch() for _ in range(3)]
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    mesh = parallel.make_mesh(jax.devices()[:1])
    test_batch = j_datasets.SyntheticDataset("test", seed=2).image_batch(1)
    with jax.default_matmul_precision("highest"):
        # `init_state`, with the init jitted (eager, it takes ~10 s here).
        model_j = j_step.build_model(config_j)
        params0 = jax.device_get(_init(model_j, j_rays.dummy_rays((8,))))
        state = TrainState.create(apply_fn=model_j.apply, params=params0,
                                  tx=j_step.make_optimizer(config_j)[0])
        step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                        camtype=dataset.camtype)
        stats_j, params_j = [], []
        for i, b in enumerate(batches):
            state, stats = step_j(state, parallel.shard_batch(b, mesh), keys[i],
                                  i / config_j.max_steps)
            stats_j.append(jax.device_get(stats))
            params_j.append(_flat_params(convert.params_from_flax(
                jax.device_get(state.params), t_step.build_model(config_t))))
        render_j = j_step.render_image(j_step.make_render_fn(config_j, model_j, mesh), params0,
                                       test_batch, mesh, chunk_size=40)

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    render_t = t_step.render_image(convert.params_from_flax(params0, t_step.build_model(config_t)),
                                   _to_torch(test_batch), chunk_size=40, device="cpu")
    stats_t, params_t = [], []
    for i, b in enumerate(batches):
        with _fed(_jax_draws(keys[i], 64, config_t.model_params["cascade_samples"])):
            stats_t.append(step_t(_to_torch(b), i, i / config_t.max_steps, torch.Generator()))
        params_t.append(_flat_params(model_t))
    return stats_j, params_j, stats_t, params_t, render_j, render_t


@pytest.mark.parametrize("n_steps", [1, 2, 3])
def test_steps_match_losses_grad_norm_and_params(steps, n_steps):
    stats_j, params_j, stats_t, params_t, _, _ = steps
    sj, st = stats_j[n_steps - 1], stats_t[n_steps - 1]
    assert set(st["loss_terms"]) == set(sj["loss_terms"])
    for k, v in sj["loss_terms"].items():
        np.testing.assert_allclose(float(st["loss_terms"][k]), float(v), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    np.testing.assert_allclose(float(st["loss"]), float(sj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(st["psnr"]), float(sj["psnr"]), rtol=1e-5)
    np.testing.assert_allclose(float(st["grad_norm"]), float(sj["grad_norm"]), rtol=1e-4)
    pj, pt = params_j[n_steps - 1], params_t[n_steps - 1]
    assert set(pj) == set(pt)
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=1e-5, rtol=1e-5, err_msg=name)


def test_steps_clip_and_use_every_term(steps):
    stats_j, _, stats_t, _, _, _ = steps
    # The global norm passes the clip of 1.0 at some step, so the clip acts.
    assert max(float(s["grad_norm"]) for s in stats_t) > 1.0
    assert set(stats_t[0]["loss_terms"]) == {"data", "depth", "autoexpo"}
    assert set(stats_t[0]["loss_terms"]) == set(stats_j[0]["loss_terms"])


def test_render_image_matches(steps):
    *_, render_j, render_t = steps
    assert set(render_t) == set(render_j)
    for key in render_t:
        assert render_t[key].shape == np.asarray(render_j[key]).shape, key
        np.testing.assert_allclose(render_t[key], np.asarray(render_j[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("kind", ["mse", "l1"])
def test_expected_depth_losses_ignore_the_fg_far_mask(kind):
    """As in the reference's dispatcher, only the KL loss reads fg_far."""
    rng = np.random.default_rng(0)
    sup = rng.uniform(-1.0, 4.0, 32).astype(np.float32)
    pred = rng.uniform(0.0, 4.0, 32).astype(np.float32)
    history = {"weights": np.full((32, 4), 0.25, np.float32),
               "steps": np.tile(np.linspace(0.1, 3.0, 4, dtype=np.float32), (32, 1)),
               "lengths": np.full((32, 4), 0.7, np.float32),
               "fg_far": np.full(32, 1.5, np.float32)}
    dirs = np.ones((32, 3), np.float32)
    got = {mask: float(t_losses.depth_loss_from_history(
        {k: torch.from_numpy(v) for k, v in history.items()}, torch.from_numpy(sup),
        torch.from_numpy(pred), torch.from_numpy(dirs), 1.0, kind, "mean_valid", mask))
        for mask in (False, True)}
    want = float(j_losses.depth_loss_from_history(history, sup, pred, dirs, 1.0, kind,
                                                   "mean_valid", True))
    assert got[True] == got[False]
    np.testing.assert_allclose(got[True], want, rtol=1e-6)


def test_cli_trains_and_evaluates_on_the_fixture(capsys, tmp_path):
    t_fixture.main(str(tmp_path / "fixture"), 12, 24, 80)
    t_cli.main(["--config", CONFIG, "--device", "cpu",
                f"scene_dir={tmp_path / 'fixture' / 'nerfpp'}", f"exp_dir={tmp_path / 'exp'}",
                "batch_size=64", "max_steps=3", "print_every=1", "checkpoint_every=2",
                "model_params=" + json.dumps(SMALL)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    train_lines = [x for x in lines if "loss" in x]
    assert [x["step"] for x in train_lines] == [1, 2, 3]
    for x in train_lines:
        assert {"loss_data", "loss_depth", "grad_norm"} <= set(x) and np.isfinite(x["loss"])
    images = [x for x in lines if "image" in x]
    assert len(images) == 1  # view 9 of 12
    mean = lines[-1]["mean"]
    assert lines[-1]["split"] == "test"
    for key in ("psnr", "ssim", "rmse", "abs_rel"):
        assert np.isfinite(mean[key]), key
    assert sorted(p.name for p in (tmp_path / "exp" / "checkpoints").iterdir()) == [
        "2", "3", "model_meta.json"]
