"""The port's Instant-NGP model, train step, occupancy refresh and CLI
against the reference package on the CPU: the same Flax weights (converted
by `params_from_flax`), the same rays and batches, the same hand-made sparse
occupancy grid, deterministic marching (`randomized=false`), and the
reference's sorted-segment table gradient (`grad_mode="sorted"`)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import __main__ as t_cli
from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.models import build as t_build
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

CONFIG = "configs/kitti_ngp.json"
# The size of the reference's own NGP model tests: two levels, one dense
# (res 4) and one hashed (res 16 in a 2^10 table).
FIELD = dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
             hidden_width=16, geo_features=7, grad_mode="sorted")
MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16, field_params=FIELD)
SMALL = [
    "dataset=synthetic", "batch_size=64", "max_steps=3", "randomized=false", "exp_dir=unused",
    "model_params=" + json.dumps(dict(MODEL, sample_budget=8)),
]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _sparse_grid(seed=0):
    """[1, 16^3]: most cells empty, the rest dense enough to render."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.0, 2.0, (1, 16**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.6] = 0.0
    return grid


def _rays(n=24, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    fields = dict(
        origins=rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32), directions=d,
        viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3, np.float32), imageplane=np.zeros((n, 2), np.float32),
        lossmult=np.ones((n, 1), np.float32), near=np.full((n, 1), 0.01, np.float32),
        far=np.full((n, 1), 30.0, np.float32), cam_idx=np.zeros((n, 1), np.int32),
    )
    return (j_rays.Rays(**{k: jnp.asarray(v) for k, v in fields.items()}),
            t_rays.Rays(**{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.fixture(scope="module")
def flax_vars():
    j_model = j_build("ngp", **MODEL)
    variables = j_model.init(jax.random.PRNGKey(0), rng=None, rays=j_rays.dummy_rays((8,)),
                             train_frac=1.0, compute_extras=False)
    return jax.device_get(variables)


@pytest.mark.parametrize("grid,budget", [(None, 0), ("sparse", 0), ("sparse", 8),
                                         ("sparse", 2)])
def test_forward_outputs_and_history(flax_vars, grid, budget):
    """Dense marching, the sparse grid, and batch compaction exact (8) and
    overflowing (2 samples per ray on average)."""
    params = dict(MODEL, sample_budget=budget)
    j_model = j_build("ngp", **params)
    t_model = convert.params_from_flax(flax_vars, t_build("ngp", **params))
    occ = None if grid is None else _sparse_grid()
    jr, tr = _rays()
    j_out, j_hist = j_model.apply(flax_vars, None, jr, occupancy=None if occ is None else
                                  jnp.asarray(occ))
    with torch.no_grad():
        t_out, t_hist = t_model(tr, occupancy=None if occ is None else torch.from_numpy(occ))
    valid = t_hist[0]["valid"].numpy()
    if grid is not None:
        assert 0 < valid.sum() < valid.size  # the grid empties some slots
    if budget == 2:
        assert valid.sum() > 2 * valid.shape[0]  # the budget overflows
    for key in ("samples_per_ray", "rm_per_ray", "vr_per_ray"):
        np.testing.assert_array_equal(t_out[0][key].numpy(), np.asarray(j_out[0][key]), key)
    np.testing.assert_array_equal(valid, np.asarray(j_hist[0]["valid"]))
    # Marching edges differ by ulps (pow in another library); the MLPs sum
    # in another order: 2e-5 on rgb/acc/weights, relative 1e-5 on distances.
    for key in ("rgb", "acc"):
        np.testing.assert_allclose(t_out[0][key].numpy(), np.asarray(j_out[0][key]),
                                   atol=2e-5, err_msg=key)
    np.testing.assert_allclose(t_hist[0]["weights"].numpy(), np.asarray(j_hist[0]["weights"]),
                               atol=2e-5)
    for key, arr in (("depth", t_out[0]["depth"]), ("steps", t_hist[0]["steps"]),
                     ("lengths", t_hist[0]["lengths"])):
        want = np.asarray(j_out[0][key] if key == "depth" else j_hist[0][key])
        np.testing.assert_allclose(arr.numpy(), want, rtol=1e-5, atol=1e-6, err_msg=key)


def test_empty_grid_marches_nothing(flax_vars):
    t_model = convert.params_from_flax(flax_vars, t_build("ngp", **MODEL))
    _, tr = _rays()
    with torch.no_grad():
        out, _ = t_model(tr, occupancy=t_model.occupancy)  # the fresh buffer: all zero
    assert torch.all(out[0]["acc"] == 0) and torch.all(out[0]["samples_per_ray"] == 0)


def _flat_flax(tree):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            elif k == "kernel":
                out[".".join(prefix + ["weight"])] = np.asarray(v).T
            else:
                out[".".join(prefix + [k])] = np.asarray(v)

    walk(tree["params"], [])
    return out


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
    config_j = j_load_config(CONFIG, SMALL)
    config_t = t_load_config(CONFIG, SMALL)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batches = [dataset.sample_batch() for _ in range(3)]
    grid = _sparse_grid(1)
    mesh = parallel.make_mesh(jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
        params0 = jax.device_get(state.params)
        step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                        camtype=dataset.camtype)
        stats_j, params_j = [], []
        for i, b in enumerate(batches):
            state, stats = step_j(state, parallel.shard_batch(b, mesh), jax.random.PRNGKey(i),
                                  i / config_j.max_steps, jnp.asarray(grid))
            stats_j.append(jax.device_get(stats))
            params_j.append(_flat_flax(jax.device_get(state.params)))
        test_batch = j_datasets.SyntheticDataset("test", seed=2).image_batch(1)
        render_j = j_step.render_image(j_step.make_render_fn(config_j, model_j, mesh), params0,
                                       test_batch, mesh, chunk_size=40, aux=jnp.asarray(grid))

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    model_t.occupancy.copy_(torch.from_numpy(grid))
    render_t = t_step.render_image(model_t, _to_torch(test_batch), chunk_size=40, device="cpu")
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    stats_t, params_t = [], []
    for i, b in enumerate(batches):
        stats_t.append(step_t(_to_torch(b), i, i / config_t.max_steps, None))
        params_t.append({n: p.detach().numpy().copy() for n, p in model_t.named_parameters()})
    return stats_j, params_j, stats_t, params_t, render_j, render_t


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match(steps, n_steps):
    stats_j, params_j, stats_t, params_t, _, _ = steps
    sj, st = stats_j[n_steps - 1], stats_t[n_steps - 1]
    assert set(st["loss_terms"]) == set(sj["loss_terms"]) == {
        "data", "depth", "distortion", "opacity"}
    # Loss terms are means over rays of f32 per-ray sums: relative 2e-5.
    for k, v in sj["loss_terms"].items():
        np.testing.assert_allclose(float(st["loss_terms"][k]), float(v), rtol=2e-5, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(st["loss"]), float(sj["loss"]), rtol=2e-5)
    for k in ("rm_s", "vr_s"):
        assert float(st[k]) == float(sj[k]), k
    # The table gradient sums bf16-rounded products whose f32 inputs come
    # out of two MLP backward passes in different orders; a product near a
    # bf16 rounding boundary can round the other way (2^-9 of that one
    # product): relative 1e-4 on the norm of all gradients.
    np.testing.assert_allclose(float(st["grad_norm"]), float(sj["grad_norm"]), rtol=1e-4)
    # Adam at lr 0.01 moves a weight by lr * g / (|g| + 1e-6), which
    # amplifies the scan's rounding on table rows whose gradient is near
    # 1e-6 (1.2e-5 seen after 3 steps): atol 5e-5, 0.5% of one step.
    pj, pt = params_j[n_steps - 1], params_t[n_steps - 1]
    assert set(pj) == set(pt)
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=5e-5, rtol=1e-5, err_msg=name)


def test_render_image_matches(steps):
    *_, render_j, render_t = steps
    assert set(render_t) == set(render_j)
    for key in render_t:
        np.testing.assert_allclose(render_t[key], np.asarray(render_j[key]), atol=2e-5,
                                   rtol=1e-5, err_msg=key)


def test_params_from_flax_takes_the_table_and_rejects_mismatch(flax_vars):
    model = convert.params_from_flax(flax_vars, t_build("ngp", **MODEL))
    np.testing.assert_array_equal(model.field.encoder.table.detach().numpy(),
                                  flax_vars["params"]["field"]["encoder"]["table"])
    tree = flax_vars["params"]
    without_table = {"field": {k: v for k, v in tree["field"].items() if k != "encoder"}}
    with pytest.raises(ValueError):
        convert.params_from_flax(without_table, t_build("ngp", **MODEL))
    extra = {"field": dict(tree["field"], encoder={"table": tree["field"]["encoder"]["table"],
                                                   "scale": np.ones(2, np.float32)})}
    with pytest.raises(ValueError):
        convert.params_from_flax(extra, t_build("ngp", **MODEL))
    bigger = dict(MODEL, field_params=dict(FIELD, log2_table_size=11))
    with pytest.raises(ValueError):
        convert.params_from_flax(flax_vars, t_build("ngp", **bigger))


def test_occupancy_refresh_cadence(monkeypatch, tmp_path):
    """Refreshes run before step 0 and then every occupancy_update_every
    steps, sweeping every cell below occupancy_warmup_steps."""
    calls = []
    make = t_step.make_occupancy_update_fn

    def recording(config, model):
        update = make(config, model)

        def wrapped(grid, generator, warmup):
            calls.append((len(calls), warmup, float(grid.abs().sum())))
            return update(grid, generator, warmup)

        return wrapped

    monkeypatch.setattr(t_step, "make_occupancy_update_fn", recording)
    config = t_load_config(CONFIG, SMALL + ["max_steps=5", "occupancy_update_every=2",
                                            "occupancy_warmup_steps=2",
                                            "occupancy_cells_per_update=64", "print_every=1",
                                            f"exp_dir={tmp_path}"])
    model, history = t_loop.train(config, device="cpu", log_fn=lambda line: None)
    assert [w for _, w, _ in calls] == [True, False, False]
    assert calls[0][2] == 0.0  # the first refresh starts from the empty grid
    assert float(model.occupancy.max()) > 0
    assert all(h["vr_s"] > 0 for h in history)  # every step marched samples


def test_cli_trains_and_evaluates_ngp_on_cpu(capsys, tmp_path):
    t_cli.main(["--config", CONFIG, "--device", "cpu", *SMALL, "print_every=1",
                "train_render_every=3", "occupancy_update_every=2", f"exp_dir={tmp_path}",
                "randomized=true"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    train_lines = [x for x in lines if "loss" in x]
    assert [x["step"] for x in train_lines] == [1, 2, 3]
    for x in train_lines:
        assert {"loss_data", "loss_depth", "loss_distortion", "loss_opacity", "rm_s",
                "vr_s"} <= set(x)
        assert np.isfinite(x["loss"]) and x["vr_s"] > 0
    assert len([x for x in lines if "test_view" in x]) == 1
    assert lines[-1]["split"] == "test" and np.isfinite(lines[-1]["mean"]["psnr"])


def test_unported_ngp_options_raise(tmp_path):
    """The options that raised NotImplementedError before they were ported
    (tests/test_torch_ngp_options.py holds them against the reference) now
    build and train; values no version takes raise ValueError."""
    ext = t_build("ngp", **dict(MODEL, optimize_ext=True, num_images=3))
    assert ext.pose_dR.weight.shape == (3, 3)
    hdr = t_build("ngp", **dict(MODEL, field_params=dict(FIELD, rgb_activation="none")))
    assert hdr.field.hdr and hasattr(hdr.field, "tonemap_out2")
    with pytest.raises(ValueError):
        t_build("ngp", **dict(MODEL, field_params=dict(FIELD, rgb_activation="relu")))
    scatter = dict(MODEL, sample_budget=8, field_params=dict(FIELD, grad_mode="scatter"))
    model, history = t_loop.train(
        t_load_config(CONFIG, SMALL + [f"exp_dir={tmp_path}", "model_params=" + json.dumps(scatter)]),
        device="cpu", log_fn=lambda line: None)
    assert not model.field.encoder.sorted_grad and np.isfinite(history[-1]["loss"])


def test_kl_depth_loss_on_point_samples():
    """The DS-NeRF KL depth loss reads NGP's point-sample history."""
    from outdoor_nerf_depth_torch.train import losses as t_losses
    from outdoor_nerf_depth_tpu.train import losses as j_losses

    rng = np.random.default_rng(5)
    hist = {"weights": rng.uniform(0.0, 0.2, (32, 16)),
            "steps": np.sort(rng.uniform(0.1, 5.0, (32, 16)), axis=-1),
            "lengths": rng.uniform(0.01, 0.3, (32, 16))}
    hist = {k: v.astype(np.float32) for k, v in hist.items()}
    sup = rng.uniform(-1.0, 5.0, 32).astype(np.float32)
    dirs = rng.normal(size=(32, 3)).astype(np.float32)
    want = j_losses.depth_loss_from_history({k: jnp.asarray(v) for k, v in hist.items()},
                                            jnp.asarray(sup), None, jnp.asarray(dirs), 0.5, "kl")
    got = t_losses.depth_loss_from_history({k: torch.from_numpy(v) for k, v in hist.items()},
                                           torch.from_numpy(sup), None, torch.from_numpy(dirs),
                                           0.5, "kl")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
