"""The port's eval and render tooling against the reference package on the
CPU: the colormap tables and the visualizations exactly (NaN and infinities
included), the image utilities, the camera paths, the analytic sphere
scene, the offline evaluator, the metric writer, and a tiny mip run through
`evaluate(save_renders=True)` and the tools `eval`, `render`, `sweep` and
`quality_gate`, checking the files they write and what they decode to."""

import importlib.util
import json
import os
import pathlib

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from outdoor_nerf_depth_torch import __main__ as t_cli
from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.tools import eval as t_eval_tool
from outdoor_nerf_depth_torch.tools import quality_gate as t_gate
from outdoor_nerf_depth_torch.tools import render as t_render
from outdoor_nerf_depth_torch.tools import sweep as t_sweep
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import metrics as t_metrics
from outdoor_nerf_depth_torch.train import offline_eval as t_offline
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_torch.utils import colormaps as t_colormaps
from outdoor_nerf_depth_torch.utils import image as t_image
from outdoor_nerf_depth_torch.utils import vis as t_vis
from outdoor_nerf_depth_torch.utils.logging import MetricWriter as TMetricWriter
from outdoor_nerf_depth_tpu.data import cameras as j_cameras
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.train import offline_eval as j_offline
from outdoor_nerf_depth_tpu.utils import image as j_image
from outdoor_nerf_depth_tpu.utils import vis as j_vis
from outdoor_nerf_depth_tpu.utils.logging import MetricWriter as JMetricWriter

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_MIP = json.dumps({
    "num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 2,
    "bg_intensity_range": [0.0, 0.0],
    "nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8,
                        "net_width_viewdirs": 8, "max_deg_point": 4},
    "prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}})
SPHERES = str(REPO / "configs" / "spheres_ablation.json")
TINY_RUN = [f"model_params={TINY_MIP}", "batch_size=64", "print_every=1"]


def _scalar_images(seed=0, shape=(23, 31)):
    """Scalar images with NaN, +-inf, exact 0 and 1 and bin edges k/256."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, shape)
    x.flat[:8] = [np.nan, np.inf, -np.inf, 0.0, 1.0, 0.5, 3 / 256, 255 / 256]
    return x


# -- colormaps and visualizations ---------------------------------------------


@pytest.mark.parametrize("name", ["turbo", "viridis", "coolwarm"])
def test_colormap_tables_are_matplotlibs(name):
    cmap = matplotlib.colormaps[name]
    cmap._init()
    assert np.array_equal(np.asarray(t_colormaps.TABLES[name]), cmap._lut[:256, :3])
    assert np.array_equal(np.asarray(t_colormaps.BAD), cmap._lut[cmap._i_bad, :3])


@pytest.mark.parametrize("name", ["turbo", "viridis", "coolwarm"])
def test_lookup_is_matplotlibs(name):
    x = _scalar_images(1)
    x = np.concatenate([x.ravel(), np.arange(257) / 256, np.nextafter(np.arange(1, 257) / 256, 0)])
    assert np.array_equal(t_vis.lookup(x, name), matplotlib.colormaps[name](x)[..., :3])


@pytest.mark.parametrize("cmap", ["turbo", "viridis", "coolwarm"])
@pytest.mark.parametrize("limits", [(None, None), (0.1, 0.9), (0.3, 0.3)])
def test_colorize_matches(cmap, limits):
    x = _scalar_images(2)
    got = t_vis.colorize(x, cmap=cmap, vmin=limits[0], vmax=limits[1],
                         invalid_color=(0.25, 0.5, 0.75))
    want = j_vis.colorize(x, cmap=cmap, vmin=limits[0], vmax=limits[1],
                          invalid_color=(0.25, 0.5, 0.75))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("with_acc", [False, True])
def test_visualize_depth_matches(with_acc):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.0, 50.0, (19, 27)).astype(np.float32)
    depth[0, :4] = [np.nan, np.inf, -np.inf, 0.0]
    acc = rng.uniform(-0.1, 1.1, depth.shape).astype(np.float32) if with_acc else None
    assert np.array_equal(t_vis.visualize_depth(depth, acc), j_vis.visualize_depth(depth, acc))


@pytest.mark.parametrize("case", ["mixed", "no_gt"])
def test_depth_error_map_matches(case):
    rng = np.random.default_rng(4)
    pred = rng.uniform(0.0, 90.0, (17, 29)).astype(np.float32)
    gt = np.where(rng.uniform(size=pred.shape) < 0.6, rng.uniform(1, 85, pred.shape), -1.0)
    if case == "no_gt":
        gt[:] = -1.0
    pred[0, 0] = np.nan
    assert np.array_equal(t_vis.depth_error_map(pred, gt), j_vis.depth_error_map(pred, gt))


def test_ray_weight_strip_and_side_by_side_match():
    rng = np.random.default_rng(5)
    tdist = np.cumsum(rng.uniform(0.01, 0.3, (6, 17)), -1)
    weights = rng.uniform(size=(6, 16))
    assert np.array_equal(t_vis.ray_weight_strip(tdist, weights, 64),
                          j_vis.ray_weight_strip(tdist, weights, 64))
    images = [rng.uniform(size=(9, 5, 3)), rng.uniform(size=(7, 4)), rng.uniform(size=(9, 3, 3))]
    got = t_vis.side_by_side(*images)
    assert got.shape == (9, 5 + 4 + 3 + 4, 3)
    assert np.array_equal(got, j_vis.side_by_side(*images))


# -- image utilities ------------------------------------------------------------


def test_srgb_curves_and_downsample_match():
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.05, 1.05, (8, 12, 3)).astype(np.float32)
    x.flat[:3] = [0.04045, 0.0031308, 0.0]
    for t_fn, j_fn in ((t_image.srgb_to_linear, j_image.srgb_to_linear),
                       (t_image.linear_to_srgb, j_image.linear_to_srgb)):
        np.testing.assert_allclose(t_fn(x).numpy(), np.asarray(j_fn(x)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_image.downsample(x, 4).numpy(),
                               np.asarray(j_image.downsample(x, 4)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        t_image.downsample(x, 5)


def test_color_correct_matches():
    rng = np.random.default_rng(7)
    ref = rng.uniform(size=(16, 20, 3))
    img = np.clip(0.8 * ref + 0.1 * ref**2 + 0.05 + 0.01 * rng.normal(size=ref.shape), 0, 1)
    np.testing.assert_allclose(t_image.color_correct(img, ref), j_image.color_correct(img, ref),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(13, 17, 3), (13, 17)])
def test_save_img_u8_pixels_equal_pils(tmp_path, shape):
    rng = np.random.default_rng(8)
    img = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    img.flat[:5] = [np.nan, np.inf, -np.inf, 254.5 / 255, 1.0]
    t_image.save_img_u8(img, str(tmp_path / "port.png"))
    j_image.save_img_u8(img, str(tmp_path / "ref.png"))
    got = png.read_png(str(tmp_path / "port.png"))
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "ref.png")))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")), got)
    # Truncated, not rounded: 254.5 / 255 is stored as 254.
    assert got.flat[3] == 254 and got.flat[4] == 255


# -- camera paths -----------------------------------------------------------------


def _ring_poses(n=12, seed=9):
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([np.cos(ang), 0.8 * np.sin(ang), 0.2 + 0.05 * rng.normal()])
        poses.append(t_cameras.view_matrix(pos + 0.02 * rng.normal(size=3),
                                           np.array([0.0, 0, 1]), pos))
    return np.stack(poses)


@pytest.mark.parametrize("kind", ["focus", "ellipse", "ellipse_z", "spiral", "spline"])
def test_camera_paths_match(kind):
    poses = _ring_poses()
    calls = {
        "focus": lambda m: m.focus_point(poses),
        "ellipse": lambda m: m.generate_ellipse_path(poses, n_frames=10),
        "ellipse_z": lambda m: m.generate_ellipse_path(poses, 7, z_variation=0.5, z_phase=0.2),
        "spiral": lambda m: m.generate_spiral_path(poses, (0.05, 4.0), n_frames=9),
        "spline": lambda m: m.generate_spline_path(poses[::2], n_interp=3),
    }
    got, want = calls[kind](t_cameras), calls[kind](j_cameras)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# -- the analytic sphere scene -----------------------------------------------------


@pytest.mark.parametrize("sup", ["gt", "stereo_like", "mono_like", "rgbonly"])
@pytest.mark.parametrize("split,every", [("train", 1), ("train", 3), ("test", 1)])
def test_sphere_scene_matches(sup, split, every):
    kw = dict(global_batch_size=32, sample_every=every, depth_sup_type=sup)
    got = t_datasets.SphereSceneDataset(split, **kw)
    want = j_datasets.SphereSceneDataset(split, **kw)
    for name in ("images", "depth_gt", "depth_sup", "camtoworlds", "pixtocams"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.near, got.far, got.n_images) == (want.near, want.far, want.n_images)
    a, b = got.sample_batch(), want.sample_batch()
    assert np.array_equal(a.rgb.numpy(), np.asarray(b.rgb))
    assert np.array_equal(a.depth_sup.numpy(), np.asarray(b.depth_sup))
    if split == "train":  # pixels, cast to rays in the train step
        for name in ("pix_x", "pix_y", "cam_idx"):
            assert np.array_equal(getattr(a.rays, name).numpy(), np.asarray(getattr(b.rays, name)))
    else:
        np.testing.assert_allclose(a.rays.directions.numpy(), np.asarray(b.rays.directions),
                                   rtol=0, atol=1e-6)


def test_unknown_sphere_prior_raises():
    with pytest.raises(ValueError, match="depth_sup_type"):
        t_datasets.SphereSceneDataset("test", depth_sup_type="lidar")


# -- offline evaluation and the metric writer ---------------------------------------


def test_evaluate_renders_matches_reference(tmp_path):
    rng = np.random.default_rng(10)
    gt_dir, pred_dir = tmp_path / "images", tmp_path / "renders"
    gt_dir.mkdir()
    pred_dir.mkdir()
    gts = rng.integers(0, 256, (30, 24, 32, 3)).astype(np.uint8)
    for i, im in enumerate(gts):
        png.write_png(str(gt_dir / f"{i:06d}.png"), im)
    # Test views 9, 19, 29: rank 0 as mip-NeRF names it, rank 1 as NeRF++
    # does, rank 2 missing.
    noisy = lambda im: np.clip(im + rng.integers(-20, 21, im.shape), 0, 255).astype(np.uint8)
    png.write_png(str(pred_dir / "color_000.png"), noisy(gts[9]))
    png.write_png(str(pred_dir / "000001.png"), noisy(gts[19]))
    logs = {"port": [], "ref": []}
    got = t_offline.evaluate_renders(str(gt_dir), str(pred_dir), str(tmp_path / "port.txt"),
                                     log_fn=logs["port"].append, device="cpu")
    want = j_offline.evaluate_renders(str(gt_dir), str(pred_dir), str(tmp_path / "ref.txt"),
                                      log_fn=logs["ref"].append)
    assert len(got[0]) == 2 and [sorted(m) for m in got[0]] == [sorted(m) for m in want[0]]
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-5), k
    assert logs["port"][2] == logs["ref"][2] == "missing prediction for test view 2 (gt idx 29)"

    def parse(path):
        rows = [line.split(" ") for line in path.read_text().splitlines()]
        return [(r[0], {k: float(v) for k, v in (kv.split("=") for kv in r[1:])}) for r in rows]

    got_rows, want_rows = parse(tmp_path / "port.txt"), parse(tmp_path / "ref.txt")
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows] == [
        "000009.png", "000019.png", "mean"]
    for (_, g), (_, w) in zip(got_rows, want_rows):
        assert g.keys() == w.keys()
        assert all(abs(g[k] - w[k]) <= 1e-4 + 1e-9 for k in w)


def test_evaluate_renders_refuses_an_empty_dir_and_a_wrong_shape(tmp_path):
    (tmp_path / "gt").mkdir()
    (tmp_path / "pred").mkdir()
    for i in range(10):
        png.write_png(str(tmp_path / "gt" / f"{i:03d}.png"), np.zeros((4, 6, 3), np.uint8))
    with pytest.raises(ValueError, match="no evaluable predictions"):
        t_offline.evaluate_renders(str(tmp_path / "gt"), str(tmp_path / "pred"),
                                   log_fn=lambda s: None, device="cpu")
    png.write_png(str(tmp_path / "pred" / "pred_000.png"), np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError, match="shape mismatch"):
        t_offline.evaluate_renders(str(tmp_path / "gt"), str(tmp_path / "pred"),
                                   log_fn=lambda s: None, device="cpu")


def test_metric_writer_matches_reference(tmp_path):
    values = {"loss": 0.25, "psnr": np.float32(31.5), "step_ms": np.float64(2.0),
              "n": 3, "vector": np.ones(3), "tensor0": np.array(4.5)}
    image = np.random.default_rng(11).uniform(-0.1, 1.1, (6, 8, 3))
    lines = {}
    for name, cls in (("port", TMetricWriter), ("ref", JMetricWriter)):
        writer = cls(str(tmp_path / name), use_tensorboard=False)
        writer.scalars(7, values, prefix="train")
        writer.scalars(8, {"psnr": 30.0})
        writer.image(8, "panel", image, out_dir=str(tmp_path / name / "images"))
        writer.histogram(8, "h", [1.0, 2.0])
        writer.close()
        lines[name] = [json.loads(s) for s in (tmp_path / name / "metrics.jsonl").read_text()
                       .splitlines()]
    for got, want in zip(lines["port"], lines["ref"]):
        assert isinstance(got.pop("time"), float) and isinstance(want.pop("time"), float)
        assert got == want
    assert lines["port"][0] == {"step": 7, "train/loss": 0.25, "train/psnr": 31.5,
                                "train/step_ms": 2.0, "train/n": 3.0, "train/tensor0": 4.5}
    assert np.array_equal(png.read_png(str(tmp_path / "port" / "images" / "panel_000008.png")),
                          np.asarray(Image.open(tmp_path / "ref" / "images" / "panel_000008.png")))


# -- a tiny mip run through the loop and the tools ------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny mip model trained 3 steps on the sphere scene (sample_every 3),
    with its in-train eval and the renders it saved."""
    exp = tmp_path_factory.mktemp("spheres")
    config = t_load_config(SPHERES, TINY_RUN + ["max_steps=3", f"exp_dir={exp}"])
    model, history = t_loop.train(config, device="cpu", log_fn=lambda s: None)
    mean, per_image = t_loop.evaluate(config, model, device="cpu", log_fn=lambda s: None)
    return config, model, history, mean, per_image


def test_train_logs_to_the_metric_writer(trained):
    config, _, history, _, _ = trained
    rows = [json.loads(s) for s in
            (pathlib.Path(config.exp_dir) / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for row, entry in zip(rows, history):
        assert row["train/loss"] == pytest.approx(entry["loss"])
        assert {f"train/{k}" for k in entry} <= set(row)


def test_evaluate_saves_the_renders(trained):
    config, model, _, _, per_image = trained
    render_dir = pathlib.Path(config.exp_dir) / "renders"
    test = t_loop.build_dataset(config, "test")
    assert len(per_image) == test.n_images == 2
    assert sorted(os.listdir(render_dir)) == [
        f"{kind}_{i:03d}.png" for kind in ("color", "depth", "summary") for i in range(2)]
    for i in range(2):
        batch = test.image_batch(i)
        out = t_step.render_image(model, batch, config.render_chunk_size, "cpu")
        color = png.read_png(str(render_dir / f"color_{i:03d}.png"))
        assert color.dtype == np.uint8 and color.shape == (64, 96, 3)
        assert np.array_equal(color, np.trunc(np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
        depth = png.read_png(str(render_dir / f"depth_{i:03d}.png"))
        codes = np.clip(out["distance_mean"] * 256.0, 0, 65535).astype(np.uint16)
        assert depth.dtype == np.uint16 and np.array_equal(depth, codes)
        gt_depth = batch.depth_gt.numpy()
        panels = [out["rgb"], batch.rgb.numpy(), t_vis.visualize_depth(out["distance_mean"]),
                  t_vis.depth_error_map(out["distance_mean"], gt_depth)]
        summary = png.read_png(str(render_dir / f"summary_{i:03d}.png"))
        assert summary.shape == (64, 4 * 96 + 3 * 2, 3)
        assert np.array_equal(summary, t_image.to_u8(t_vis.side_by_side(*panels)))


def test_eval_tool_restores_and_matches_the_in_train_eval(trained, capsys):
    config, _, _, _, per_image = trained
    mean, got = t_eval_tool.main(["--config", os.path.join(config.exp_dir, "config.json"),
                                  "--device", "cpu"])
    assert "restored step 3" in capsys.readouterr().out
    for g, w in zip(got, per_image):
        for k in ("psnr", "ssim", "rmse", "abs_rel"):
            assert g[k] == pytest.approx(w[k], abs=1e-6)


def test_eval_tool_offline_scores_the_saved_renders(trained, tmp_path):
    config, _, _, _, _ = trained
    # The scene's test views as an image folder: 20 views, test ranks 0, 1.
    scene = t_datasets.SphereSceneDataset("train", n_images=24)
    test = t_datasets.SphereSceneDataset("test", n_images=24)
    folder = tmp_path / "images"
    folder.mkdir()
    views = list(scene.images[:9]) + [test.images[0]] + list(scene.images[9:18]) + [test.images[1]]
    for i, im in enumerate(views):
        t_image.save_img_u8(im, str(folder / f"{i:03d}.png"))
    out = tmp_path / "metrics.txt"
    per_image, mean = t_eval_tool.main(
        ["--offline", str(folder), os.path.join(config.exp_dir, "renders"), str(out),
         "--device", "cpu"])
    assert len(per_image) == 2 and out.read_text().splitlines()[-1].startswith("mean psnr=")
    for rank in range(2):
        pred = png.read_png(os.path.join(config.exp_dir, "renders", f"color_{rank:03d}.png"))
        gt = t_image.to_u8(test.images[rank])
        want = t_metrics.MetricSuite()(pred / 255.0, gt / 255.0)
        assert per_image[rank]["psnr"] == pytest.approx(want["psnr"], abs=1e-4)
        assert per_image[rank]["ssim"] == pytest.approx(want["ssim"], abs=1e-4)


@pytest.mark.parametrize("kind", list(t_render.PATHS))
def test_render_tool_writes_every_path(trained, kind):
    config, _, _, _, _ = trained
    result = t_render.main(["--config", os.path.join(config.exp_dir, "config.json"),
                            "--device", "cpu", f"path={kind}", "n_frames=2"])
    train_views = t_loop.build_dataset(config, "train").n_images
    # The spline runs through every len // 8-th training pose, one frame per segment.
    want = {"ellipse": 2, "spiral": 2, "train": 2,
            "spline": len(range(0, train_views, max(1, train_views // 8))) - 1}[kind]
    assert len(result["frames"]) == len(result["frame_ms"]) == want
    for path in result["frames"]:
        frame = png.read_png(path)
        assert frame.shape == (64, 2 * 96 + 2, 3) and frame.dtype == np.uint8


def test_render_tool_keeps_the_field_of_view_at_another_size(trained):
    config, model, _, _, _ = trained
    result = t_render.main(["--config", os.path.join(config.exp_dir, "config.json"),
                            "--device", "cpu", "path=train", "n_frames=1", "render_height=32"])
    assert (result["height"], result["width"]) == (32, 48)
    frame = png.read_png(result["frames"][0])
    assert frame.shape == (32, 2 * 48 + 2, 3)
    # At half the grid, pixel (x, y) looks where the full-size camera looks
    # at (2x + 1, 2y + 1), the corner its four full-size pixels share.
    dataset = t_loop.build_dataset(config, "train")
    pose = dataset.camtoworlds[0]
    half = t_render.frame_batch(pose, dataset.pixtocams @ np.diag([2.0, 2.0, 1.0]).astype(np.float32),
                                32, 48, dataset.near, dataset.far)
    px, py = t_cameras.pixel_grid(48, 32)
    full = t_cameras.pixels_to_rays(torch.tensor(2 * px + 0.5, dtype=torch.float32),
                                    torch.tensor(2 * py + 0.5, dtype=torch.float32),
                                    torch.tensor(dataset.pixtocams), torch.tensor(pose))
    np.testing.assert_allclose(half.rays.directions.numpy(), full[1].numpy(), rtol=0, atol=1e-6)


def test_render_tool_refuses_an_unknown_path(trained):
    config, _, _, _, _ = trained
    with pytest.raises(ValueError, match="unknown path"):
        t_render.main(["--config", os.path.join(config.exp_dir, "config.json"),
                       "--device", "cpu", "path=orbit"])


def test_sweep_dry_run_and_two_points(tmp_path, capsys):
    base = ["--config", SPHERES, "--device", "cpu", f"exp_dir={tmp_path}", *TINY_RUN,
            "max_steps=2", "--grid", "depth_sup_type=gt,rgbonly"]
    assert t_sweep.main(base + ["--dry-run"]) == {}
    assert "depth_sup_type_rgbonly" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []
    results = t_sweep.main(base)
    assert sorted(results) == ["depth_sup_type_gt", "depth_sup_type_rgbonly"]
    summary = json.loads((tmp_path / "sweep_summary.json").read_text())
    assert summary == json.loads(json.dumps(results))
    for name in results:
        assert (tmp_path / name / "checkpoints" / "2").is_dir()
        assert np.isfinite(results[name]["psnr"])


def _tiny_gates(thresholds):
    small = {
        "mipnerf360": dict(model="mipnerf360", model_params=json.loads(TINY_MIP)),
        "nerfpp": dict(model="nerfpp", model_params=dict(
            cascade_samples=(6, 6), net_depth=2, net_width=16, pos_degrees=4, view_degrees=2)),
        "ngp": dict(model="ngp", model_params=dict(
            scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16,
            field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                              max_resolution=16, hidden_width=16, geo_features=7))),
    }
    gates = {}
    for name, gate in t_gate.GATES.items():
        config = dict(gate["config"], **small[name])
        gates[name] = dict(gate, steps=10, batch=64, thresholds=thresholds, config=config)
    return gates


@pytest.mark.parametrize("passes", [True, False])
def test_quality_gate_json_and_exit_code(tmp_path, monkeypatch, passes):
    thresholds = dict(psnr=-100.0, rmse=1e3) if passes else dict(psnr=100.0, rmse=1e3)
    monkeypatch.setattr(t_gate, "GATES", _tiny_gates(thresholds))
    out = tmp_path / "gate.json"
    backends = "mipnerf360,nerfpp,ngp" if passes else "ngp"
    code = t_gate.main([f"backends={backends}", f"out={out}", f"exp_root={tmp_path}",
                        "--device", "cpu"])
    assert code == (0 if passes else 1)
    result = json.loads(out.read_text())
    assert result["device"] == "cpu" and result["n_devices"] == 1 and result["steps_scale"] == 1.0
    assert result["all_passed"] is passes
    assert [g["backend"] for g in result["gates"]] == backends.split(",")
    for g in result["gates"]:
        assert sorted(g) == ["backend", "batch", "eval_seconds", "final_train_psnr",
                             "median_step_ms", "metrics", "passed", "steps", "thresholds",
                             "train_seconds"]
        assert g["steps"] == 10 and g["batch"] == 64 and g["passed"] is passes
        assert {"psnr", "ssim", "rmse", "abs_rel", "n_valid"} <= set(g["metrics"])
        assert (tmp_path / g["backend"] / "renders" / "color_001.png").is_file()


def test_quality_gate_config_is_the_references():
    spec = importlib.util.spec_from_file_location("j_quality_gate", REPO / "quality_gate.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert t_gate.GATES == ref.GATES
    config = t_gate.gate_config("ngp", "/x", steps_scale=0.1)
    assert (config.max_steps, config.steps_per_dispatch, config.render_chunk_size,
            config.print_every, config.checkpoint_every, config.dataset) == (
        60, 8, 8192, 50, 60, "spheres")
    t_step.build_model(t_gate.gate_config("mipnerf360", "/x"))


def test_spheres_config_trains_and_evaluates_through_the_cli(tmp_path, capsys):
    t_cli.main(["--config", SPHERES, "--device", "cpu", "max_steps=2", *TINY_RUN,
                f"exp_dir={tmp_path}"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [line["step"] for line in lines if "loss" in line] == [1, 2]
    assert lines[-1]["split"] == "test" and np.isfinite(lines[-1]["mean"]["psnr"])
    assert lines[-1]["mean"]["n_valid"] > 0
