"""The port's KITTI data path against the reference package on the CPU: the
PNG codec against PIL, the COLMAP readers and writers, the depth decode,
the view split, the pose normalization, the fixture writer, the
driving-scene and NeRF++ datasets, and short train and eval runs on the
fixture."""

import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import colmap as t_colmap
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.tools import make_kitti_fixture as t_fixture
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu.data import cameras as j_cameras
from outdoor_nerf_depth_tpu.data import colmap as j_colmap
from outdoor_nerf_depth_tpu.data import datasets as j_datasets

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N_VIEWS, HEIGHT, WIDTH = 12, 24, 80


# -- PNG ---------------------------------------------------------------------


def _images():
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:23, 0:37]
    smooth = np.stack([x * 5, y * 7, x + 2 * y], -1) % 256  # provokes Sub/Up/Paeth rows
    return {
        "rgb8": rng.integers(0, 256, (23, 37, 3)).astype(np.uint8),
        "rgb8_smooth": smooth.astype(np.uint8),
        "grey16": rng.integers(0, 65536, (19, 41)).astype(np.uint16),
        "grey16_smooth": (x[:19, :, None] * 1500 + y[:19, :, None] * 900)[..., 0].astype(np.uint16),
        "grey8": rng.integers(0, 256, (5, 9)).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (7, 6, 4)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_png_reads_what_pil_writes(name):
    image = _images()[name]
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    got = png.decode_png(buf.getvalue())
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("name", sorted(_images()))
def test_pil_reads_what_png_writes(name):
    image = _images()[name]
    got = np.asarray(Image.open(io.BytesIO(png.encode_png(image))))
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, image)


def _filtered_png(image: np.ndarray) -> bytes:
    """A PNG whose row y uses filter y % 5, filtered by a plain loop."""
    h = image.shape[0]
    depth = 8 * image.dtype.itemsize
    channels = 1 if image.ndim == 2 else image.shape[2]
    rows = np.ascontiguousarray(image, ">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).astype(np.int64)
    bpp = channels * depth // 8
    out = bytearray()
    for y in range(h):
        kind = y % 5
        out.append(kind)
        for i in range(rows.shape[1]):
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y > 0 else 0
            c = rows[y - 1, i - bpp] if y > 0 and i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else \
                b if abs(p - b) <= abs(p - c) else c
            pred = [0, a, b, (a + b) // 2, paeth][kind]
            out.append((rows[y, i] - pred) % 256)
    colour = {1: 0, 3: 2, 4: 6}[channels]
    ihdr = struct.pack(">IIBBBBB", image.shape[1], h, depth, colour, 0, 0, 0)
    chunk = lambda k, p: struct.pack(">I", len(p)) + k + p + struct.pack(">I", zlib.crc32(k + p))
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["rgb8", "rgb8_smooth", "grey16", "grey16_smooth", "rgba8"])
def test_png_reads_every_row_filter(name):
    image = _images()[name]
    data = _filtered_png(image)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(want, image)  # PIL agrees the file holds the image
    got = png.decode_png(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _pil_png(image, mode=None, **save):
    buf = io.BytesIO()
    (Image.fromarray(image) if mode is None else Image.fromarray(image).convert(mode)).save(
        buf, format="PNG", **save)
    return buf.getvalue()


def _with_header(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields replaced (bit depth, colour, interlace)."""
    start = len(png.SIGNATURE)
    values = list(struct.unpack(">IIBBBBB", data[start + 8:start + 21]))
    for key, value in fields.items():
        values[{"depth": 2, "colour": 3, "interlace": 6}[key]] = value
    payload = struct.pack(">IIBBBBB", *values)
    chunk = struct.pack(">I", 13) + b"IHDR" + payload + struct.pack(">I", zlib.crc32(b"IHDR" + payload))
    return data[:start] + chunk + data[start + 25:]


def test_png_unsupported_modes_raise():
    rgb = _images()["rgb8"]
    cases = {
        "palette": _pil_png(rgb, "P"),
        "grey and alpha": _pil_png(rgb, "LA"),
        "1-bit grey": _pil_png(rgb, "1"),
        "16-bit RGB": _with_header(_pil_png(rgb), depth=16),
        "interlaced": _with_header(_pil_png(rgb), interlace=1),
    }
    for name, data in cases.items():
        with pytest.raises(ValueError):
            png.decode_png(data)
        assert name
    bad_crc = bytearray(_pil_png(rgb))
    bad_crc[len(png.SIGNATURE) + 12] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    with pytest.raises(ValueError):
        png.decode_png(b"GIF89a")
    for image in (rgb.astype(np.uint16), rgb.astype(np.float32), rgb[..., :2]):
        with pytest.raises(ValueError):
            png.encode_png(image)


# -- COLMAP ------------------------------------------------------------------


def _model(mod, seed=0):
    rng = np.random.default_rng(seed)
    cams = {1: mod.Camera(1, "PINHOLE", 80, 24, rng.uniform(10, 100, 4)),
            2: mod.Camera(2, "OPENCV", 64, 48, rng.uniform(-1, 1, 8))}
    images = {i: mod.Image(i, rng.normal(size=4), rng.normal(size=3), 1 + i % 2, f"{i:04d}.png",
                           rng.uniform(0, 80, (i, 2)), rng.integers(-1, 50, i))
              for i in range(1, 5)}
    points = {i: mod.Point3D(i, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
                             float(rng.uniform()), rng.integers(1, 5, i), rng.integers(0, 9, i))
              for i in range(1, 6)}
    return cams, images, points


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_colmap_writers_and_readers_match_the_reference(tmp_path):
    for fmt in ("bin", "txt"):
        for mod in (j_colmap, t_colmap):
            d = tmp_path / f"{mod.__name__.split('.')[0]}_{fmt}"
            d.mkdir()
            cams, images, points = _model(mod)
            for stem, obj in (("cameras", cams), ("images", images), ("points3d", points)):
                getattr(mod, f"write_{stem}_{fmt}")(obj, str(d / f"{stem}.{fmt}"))
        j_dir, t_dir = (tmp_path / f"outdoor_nerf_depth_{x}_{fmt}" for x in ("tpu", "torch"))
        for stem in ("cameras", "images", "points3d"):
            assert (t_dir / f"{stem}.{fmt}").read_bytes() == (j_dir / f"{stem}.{fmt}").read_bytes()
            want = getattr(j_colmap, f"read_{stem}_{fmt}")(str(j_dir / f"{stem}.{fmt}"))
            got = getattr(t_colmap, f"read_{stem}_{fmt}")(str(t_dir / f"{stem}.{fmt}"))
            assert set(got) == set(want)
            for key in want:
                _same(got[key], want[key])


def test_quaternions_round_trip_like_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.normal(size=4)
        r = t_colmap.quaternion_to_rotation(q)
        np.testing.assert_array_equal(r, j_colmap.quaternion_to_rotation(q))
        np.testing.assert_array_equal(t_colmap.rotation_to_quaternion(r),
                                      j_colmap.rotation_to_quaternion(r))


# -- depth decode, split, poses ---------------------------------------------


@pytest.mark.parametrize("crop,keep", [(0.0, 0.0), (30.0, 0.0), (0.0, 0.3), (40.0, 0.2)])
def test_decode_depth_png_matches_the_reference(crop, keep):
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 80 * 256, (24, 80)).astype(np.float32)
    raw[rng.uniform(size=raw.shape) < 0.3] = 0.0
    args = dict(scene_scale=0.0985, crop_range=crop, keep_ratio=keep, seed=4)
    np.testing.assert_array_equal(t_datasets.decode_depth_png(raw, **args),
                                  j_datasets.decode_depth_png(raw, **args))
    with pytest.raises(ValueError):
        t_datasets.decode_depth_png(raw, 1.0, keep_ratio=0.9)


@pytest.mark.parametrize("n", [1, 9, 10, 12, 30, 57])
@pytest.mark.parametrize("sample_every", [1, 2, 4])
def test_split_indices_match_the_reference(n, sample_every):
    for split in ("train", "test"):
        got = t_datasets.split_indices(n, split, sample_every)
        want = j_datasets.split_indices(n, split, sample_every)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pose_normalization_matches_the_reference():
    poses = t_fixture.camera_path(30).astype(np.float64)
    poses[:, :3, 3] += np.random.default_rng(0).normal(0, 0.3, (30, 3))
    got, got_t = t_cameras.normalize_poses_pca(poses.copy())
    want, want_t = j_cameras.normalize_poses_pca(poses.copy())
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got_t, want_t, atol=1e-12, rtol=0)
    assert abs(t_cameras.pose_scale(got_t) - j_cameras.pose_scale(want_t)) < 1e-12
    got, got_t = t_cameras.recenter_poses(poses)
    want, want_t = j_cameras.recenter_poses(poses)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got_t, want_t, atol=1e-12, rtol=0)
    np.testing.assert_allclose(t_cameras.pad_pose(poses), j_cameras.pad_pose(poses), atol=0)


# -- the fixture and the dataset ---------------------------------------------


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The scene written by the port's tool and by the reference tool."""
    root = tmp_path_factory.mktemp("kitti")
    spec = importlib.util.spec_from_file_location("reference_fixture",
                                                  REPO / "tools" / "make_kitti_fixture.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    reference.main(str(root / "reference"), N_VIEWS, HEIGHT, WIDTH)
    t_fixture.main(str(root / "port"), N_VIEWS, HEIGHT, WIDTH)
    return root / "port", root / "reference"


def test_fixture_files_match_the_reference_tool(fixtures):
    port, reference = fixtures
    files = sorted(p.relative_to(reference) for p in reference.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    # dtu_format: images, depths_gt, three priors; nerfpp: rgb, depth, one prior, min_depth
    assert len([f for f in files if f.suffix == ".png"]) == 5 * N_VIEWS + 4 * N_VIEWS
    for rel in files:
        if rel.suffix == ".png":  # pixels, depth codes and priors, decoded by PIL
            got, want = (np.asarray(Image.open(d / rel)) for d in (port, reference))
            assert got.dtype == want.dtype, rel
            np.testing.assert_array_equal(got, want, err_msg=str(rel))
        else:  # COLMAP bins, txt poses, the scale file
            assert (port / rel).read_bytes() == (reference / rel).read_bytes(), rel


def test_fixture_decodes_alike_with_the_reference_loader(fixtures):
    port, reference = fixtures
    for split in ("train", "test"):
        got, want = (j_datasets.DrivingSceneDataset(str(d / "dtu_format"), split, 16,
                                                    depth_sup_type="stereo_crop")
                     for d in (port, reference))
        for name in ("images", "depth_gt", "depth_sup"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        np.testing.assert_allclose(got.camtoworlds, want.camtoworlds, atol=1e-6)
        assert got.scene_scale == want.scene_scale


_DATASET_CASES = {
    "gt_train": dict(split="train"),
    "gt_test": dict(split="test"),
    "stereo_crop_sparse": dict(split="train", depth_sup_type="stereo_crop", sample_every=2),
    "mono_crop_keep": dict(split="train", depth_sup_type="mono_crop", depth_crop_range=50.0,
                           depth_keep_ratio=0.02),
    "rgbonly": dict(split="train", depth_sup_type="gt", load_depth=False),
    "rgbonly_test": dict(split="test", load_depth=False),
}


@pytest.mark.parametrize("case", sorted(_DATASET_CASES))
def test_driving_dataset_matches_the_reference(fixtures, case):
    kwargs = dict(_DATASET_CASES[case])
    split = kwargs.pop("split")
    scene = str(fixtures[0] / "dtu_format")
    args = (scene, split, 64)
    kwargs.update(near=0.2, far=1e6)
    got = t_datasets.DrivingSceneDataset(*args, **kwargs)
    want = j_datasets.DrivingSceneDataset(*args, **kwargs)
    for name in ("images", "depth_gt", "depth_sup", "camtoworlds", "pixtocams"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.near, got.far, got.scene_scale) == (want.near, want.far, want.scene_scale)
    assert (got.camtype, got.distortion) == (want.camtype, want.distortion)
    for _ in range(2):
        g, w = got.sample_batch(), want.sample_batch()
        assert type(g.rays).__name__ == type(w.rays).__name__
        for f in dataclasses.fields(w.rays):
            wv = getattr(w.rays, f.name)
            if wv is None:
                continue
            gv = getattr(g.rays, f.name).numpy()
            if split == "train":  # pixels, cast on the device later: exact
                np.testing.assert_array_equal(gv, wv, err_msg=f.name)
            else:  # host-cast rays: the reference casts in float64, the port in float32
                np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6, err_msg=f.name)
        for name in ("rgb", "depth_gt", "depth_sup"):
            gv, wv = getattr(g, name), getattr(w, name)
            assert (gv is None) == (wv is None), name
            if wv is not None:
                np.testing.assert_array_equal(gv.numpy(), wv, err_msg=name)


_NERFPP_CASES = {
    "gt_train": dict(split="train"),
    "gt_test": dict(split="test"),
    "stereo_crop_skip": dict(split="train", depth_sup_type="stereo_crop", skip=2),
    "min_depth_map": dict(split="train", min_depth_map=True),
}


@pytest.mark.parametrize("case", sorted(_NERFPP_CASES))
def test_nerfpp_dataset_matches_the_reference(fixtures, tmp_path, case):
    kwargs = dict(_NERFPP_CASES[case])
    split = kwargs.pop("split")
    scene = fixtures[0] / "nerfpp"
    if kwargs.pop("min_depth_map", False):
        # The fixture's min-depth maps are all 0: write varied ones and a
        # max_depth.txt, so each ray's near bound differs.
        scene = tmp_path / "nerfpp"
        shutil.copytree(fixtures[0] / "nerfpp", scene)
        rng = np.random.default_rng(8)
        for f in sorted((scene / split / "min_depth").iterdir()):
            png.write_png(str(f), rng.integers(0, 256, (HEIGHT, WIDTH)).astype(np.uint8))
        (scene / split / "max_depth.txt").write_text("37.5\n")
    args = (str(scene), split, 64)
    got = t_datasets.NerfppSceneDataset(*args, **kwargs)
    want = j_datasets.NerfppSceneDataset(*args, **kwargs)
    for name in ("images", "depth_gt", "depth_sup", "min_depth", "camtoworlds", "pixtocams"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.near, got.far, got.scene_scale) == (want.near, want.far, want.scene_scale)
    assert got.scene_scale != 1.0 and got.n_images == want.n_images
    for _ in range(2):
        g, w = got.sample_batch(), want.sample_batch()
        assert type(g.rays).__name__ == type(w.rays).__name__
        for f in dataclasses.fields(w.rays):
            wv = getattr(w.rays, f.name)
            if wv is None:
                continue
            gv = getattr(g.rays, f.name).numpy()
            if split == "train":  # pixels, cast on the device later: exact
                np.testing.assert_array_equal(gv, wv, err_msg=f.name)
            else:  # host-cast rays: the reference casts in float64, the port in float32
                np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6, err_msg=f.name)
        for name in ("rgb", "depth_gt", "depth_sup"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), getattr(w, name),
                                          err_msg=name)
    near = g.rays.near.numpy()
    if case == "min_depth_map":
        assert near.min() >= 1e-4 and near.max() > 1.0
    else:
        np.testing.assert_array_equal(near, np.float32(1e-4))


def test_trace_sphere_scene_matches_the_reference_bit_for_bit():
    scene = t_fixture.make_scene()
    c2w = t_fixture.camera_path(3)[2]
    k = np.array([[96.0, 0, 40.0], [0, 96.0, 12.0], [0, 0, 1.0]], np.float32)
    got = t_datasets.trace_sphere_scene(c2w, np.linalg.inv(k), HEIGHT, WIDTH, 0.5, **scene)
    want = j_datasets.trace_sphere_scene(c2w, np.linalg.inv(k), HEIGHT, WIDTH, 0.5, **scene)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- short runs on the fixture ----------------------------------------------

MIP_SMALL = [
    "batch_size=64", "max_steps=3", "print_every=1", "checkpoint_every=2",
    'model_params={"num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 3, '
    '"raydist_fn": "reciprocal", "opaque_background": true, "single_jitter": true, '
    '"nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8, '
    '"net_width_viewdirs": 8, "max_deg_point": 4}, '
    '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}',
]
NGP_SMALL = [
    "batch_size=64", "max_steps=3", "print_every=1", "checkpoint_every=2",
    "occupancy_update_every=2",
    "model_params=" + json.dumps(dict(
        scale=8.0, max_samples=16, n_candidates=64, grid_resolution=16, sample_budget=8,
        field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
                          hidden_width=16, geo_features=7))),
]


@pytest.mark.parametrize("config,small", [("configs/kitti_mipnerf360.json", MIP_SMALL),
                                          ("configs/kitti_ngp.json", NGP_SMALL)])
def test_train_and_evaluate_on_the_fixture(fixtures, tmp_path, config, small):
    scene = fixtures[0] / "dtu_format"
    config = t_load_config(str(REPO / config),
                           [f"scene_dir={scene}", f"exp_dir={tmp_path}", *small])
    assert config.dataset == "driving"
    lines = []
    model, history = t_loop.train(config, device="cpu", log_fn=lines.append)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and "loss_depth" in h for h in history)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2", "3", "model_meta.json"]
    assert json.loads((tmp_path / "config.json").read_text())["scene_dir"] == str(scene)
    mean, per_image = t_loop.evaluate(config, model, device="cpu", log_fn=lines.append)
    assert len(per_image) == 1  # views 9 of 12
    for key in ("psnr", "ssim", "rmse", "abs_rel"):
        assert np.isfinite(mean[key]), key
    assert mean["n_valid"] > 0

