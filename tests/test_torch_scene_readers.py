"""The port's public scene readers against the reference package on the CPU:
Blender, Tanks and Temples (NeRF++ and Free View Synthesis layouts), DTU,
NSVF and RTMV, each on a small layout this file writes (the port's PNG
writer, `np.save`, `np.savetxt`, `json`). Arrays and the first batch are
held exactly, host-cast rays at 1e-6, `decompose_projection` at 1e-10, and
`build_dataset` on every dataset name the reference's takes. A deliberate
difference: the port has no JPEG decoder, so a `.jpg` view raises."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.tools import make_blender_fixture as t_blender
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train.config import Config as TConfig
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.train import loop as j_loop
from outdoor_nerf_depth_tpu.train.config import Config as JConfig

torch.set_num_threads(1)

BATCH = 32
# Host-cast rays: the reference casts in float64 after its float32 camera
# product, the port in float32 throughout.
RAY_TOL = 1e-6


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _rgb(rng, h, w, channels=3):
    return rng.integers(0, 256, (h, w, channels)).astype(np.uint8)


def _look_at_pose(rng, radius):
    """OpenGL camera-to-world on a sphere of `radius`, looking at the origin."""
    pos = rng.normal(size=3)
    pos = radius * pos / np.linalg.norm(pos)
    z = pos / np.linalg.norm(pos)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    pose[:3, 3] = pos
    return pose


def write_blender(root, n_train=4, n_test=2, h=8, w=10, seed=1):
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            name = f"{split}/r_{i}"
            png.write_png(os.path.join(root, name + ".png"), _rgb(rng, h, w, 4))
            # One frame names its file with the extension, the rest without.
            path = f"./{name}.png" if i == 1 else name
            frames.append({"file_path": path,
                           "transform_matrix": _look_at_pose(rng, 4.0).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)


def write_tnt(root, n_train=4, n_test=2, h=8, w=12, seed=2):
    """The NeRF++ layout of a Tanks and Temples scene: txt cameras, rgb."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        for sub in ("intrinsics", "pose", "rgb"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(n):
            k = np.eye(4)
            k[:3, :3] = [[9.0 + i, 0, w / 2], [0, 9.5, h / 2], [0, 0, 1]]
            pose = np.eye(4)
            pose[:3, :3] = _rotation(rng)
            pose[:3, 3] = rng.uniform(-0.5, 0.5, 3)
            np.savetxt(os.path.join(root, split, "intrinsics", f"{i:06d}.txt"), k.reshape(1, 16))
            np.savetxt(os.path.join(root, split, "pose", f"{i:06d}.txt"), pose.reshape(1, 16))
            png.write_png(os.path.join(root, split, "rgb", f"{i:06d}.png"), _rgb(rng, h, w))


def write_fvs(root, n=12, h=6, w=8, seed=22, ext=".png"):
    """Two pyramid levels; factor 0 picks the larger name, ibr3d_pw_0.50."""
    rng = np.random.default_rng(seed)
    Rs = np.stack([_rotation(rng) for _ in range(n)])
    ts = rng.normal(size=(n, 3))
    for level, scale in (("ibr3d_pw_0.25", 1), ("ibr3d_pw_0.50", 2)):
        base = os.path.join(root, "dense", level)
        os.makedirs(base, exist_ok=True)
        for i in range(n):
            image = _rgb(rng, h * scale, w * scale)
            if ext == ".png":
                png.write_png(os.path.join(base, f"im_{i:08d}.png"), image)
            else:  # only the name matters: the reader refuses it before decoding
                open(os.path.join(base, f"im_{i:08d}{ext}"), "wb").close()
        Ks = np.tile(np.array([[7.0 * scale, 0, 4.0 * scale], [0, 7.5 * scale, 3.0 * scale],
                               [0, 0, 1]]), (n, 1, 1))
        for name, arr in (("Ks", Ks), ("Rs", Rs), ("ts", ts)):
            np.save(os.path.join(base, f"{name}.npy"), arr)


def write_dtu(root, n=9, h=12, w=16, seed=23, light_cond=7):
    """A scan dir with its projections in a local cal18/ (`root/scan1`)."""
    rng = np.random.default_rng(seed)
    scan = os.path.join(root, "scan1")
    os.makedirs(os.path.join(scan, "cal18"), exist_ok=True)
    K = np.array([[30.0, 0.2, 8.0], [0, 31.0, 6.0], [0, 0, 1.0]])
    for i in range(1, n + 1):
        lights = ["max"] if light_cond == 7 else [f"{c}_r5000" for c in range(8)]
        for light in lights:
            png.write_png(os.path.join(scan, f"rect_{i:03d}_{light}.png"), _rgb(rng, h, w))
        P = K @ np.concatenate([_rotation(rng), rng.normal(size=(3, 1)) * 2.0], axis=1)
        np.savetxt(os.path.join(scan, "cal18", f"pos_{i:03d}.txt"), P * 2.5)
    return scan


def write_nsvf(root, counts=(("0_", 4), ("1_", 2)), h=12, w=16, seed=24, scalar_focal=False):
    rng = np.random.default_rng(seed)
    for sub in ("rgb", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    intr = np.array([20.0]) if scalar_focal else np.array(
        [[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1.0]])
    np.savetxt(os.path.join(root, "intrinsics.txt"), intr)
    np.savetxt(os.path.join(root, "bbox.txt"), np.array([[-2.0, -1.5, -1, 2, 2.5, 1.0, 0.1]]))
    for prefix, count in counts:
        for i in range(count):
            png.write_png(os.path.join(root, "rgb", f"{prefix}{i:04d}.png"), _rgb(rng, h, w, 4))
            pose = np.eye(4)
            pose[:3, :3] = _rotation(rng)
            pose[:3, 3] = rng.normal(size=3)
            np.savetxt(os.path.join(root, "pose", f"{prefix}{i:04d}.txt"), pose)


def write_rtmv(root, n=8, h=12, w=16, seed=25):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, :3] = _rotation(rng)
        c2w[:3, 3] = rng.normal(size=3)
        meta = {"camera_data": {
            "cam2world": c2w.T.tolist(),
            "intrinsics": {"fx": 20.0, "fy": 21.0, "cx": 8.0, "cy": 6.0},
            "width": w, "height": h,
            "scene_center_3d_box": [0.1, -0.2, 0.3],
            "scene_min_3d_box": [-1.0, -1.5, -1.0],
            "scene_max_3d_box": [1.0, 1.2, 1.4],
        }}
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump(meta, f)
        # RGBA and RGB views: both are read, RGBA composited over white.
        png.write_png(os.path.join(root, "images", f"{i:05d}.png"), _rgb(rng, h, w, 4 - i % 2))


# (reader class name, layout writer, the reader's scene dir below the
# written root, splits, keyword arguments)
CASES = {
    "blender": ("BlenderDataset", write_blender, "", ("train", "test"), {}),
    "blender_black_bg": ("BlenderDataset", write_blender, "", ("train",),
                         dict(white_background=False, near=0.5, far=3.0)),
    "blender_fixture_tool": ("BlenderDataset", lambda root: t_blender.main(root, 3, 2, 24),
                             "", ("train", "test"), dict(near=0.05, far=4.0)),
    "tnt": ("TanksAndTemplesDataset", write_tnt, "", ("train", "test"), {}),
    "tnt_skip": ("TanksAndTemplesDataset", write_tnt, "", ("train",), dict(skip=2)),
    "tnt_fvs": ("TanksAndTemplesFVSDataset", write_fvs, "", ("train", "test"), {}),
    "tnt_fvs_factor1": ("TanksAndTemplesFVSDataset", write_fvs, "", ("train",),
                        dict(factor=1, llffhold=4)),
    "dtu": ("DTUDataset", write_dtu, "scan1", ("train", "test"), {}),
    "dtu_light3": ("DTUDataset", lambda root: write_dtu(root, n=3, light_cond=3), "scan1",
                   ("train", "test"), dict(light_cond=3, dtuhold=2)),
    "nsvf": ("NSVFDataset", write_nsvf, "", ("train", "test"), {}),
    "nsvf_scalar_focal_synthetic_test": (
        "NSVFDataset", lambda root: write_nsvf(root, (("0_", 3), ("2_", 2)), scalar_focal=True),
        "", ("train", "test"), dict(white_background=False)),
    "rtmv": ("RTMVDataset", write_rtmv, "", ("all", "train", "trainval"), {}),
    "rtmv_unnormalized": ("RTMVDataset", write_rtmv, "", ("all",), dict(normalize_box=False)),
}
ARRAYS = ("images", "camtoworlds", "pixtocams", "depth_gt", "depth_sup", "min_depth")
SCALARS = ("near", "far", "scene_scale", "n_images", "height", "width", "camtype", "distortion")


def _assert_same_rays(got, want, exact):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        wv = getattr(want, f.name)
        if wv is None:
            assert getattr(got, f.name) is None, f.name
            continue
        gv = getattr(got, f.name).numpy()
        if exact:
            assert gv.dtype == np.asarray(wv).dtype, f.name
            np.testing.assert_array_equal(gv, wv, err_msg=f.name)
        else:
            np.testing.assert_allclose(gv, wv, rtol=RAY_TOL, atol=RAY_TOL, err_msg=f.name)


def _assert_same_batch(got, want, exact):
    _assert_same_rays(got.rays, want.rays, exact)
    for name in ("rgb", "depth_gt", "depth_sup"):
        gv, wv = getattr(got, name), getattr(want, name)
        assert (gv is None) == (wv is None), name
        if wv is not None:
            np.testing.assert_array_equal(gv.numpy(), wv, err_msg=name)


def _assert_same_dataset(got, want):
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    for name in SCALARS:
        assert getattr(got, name) == getattr(want, name), name
    for name in ("shift", "scale"):  # NSVF's and RTMV's box normalization
        assert hasattr(got, name) == hasattr(want, name), name
        if hasattr(want, name):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_matches_the_reference(tmp_path, case):
    cls, write, sub, splits, kwargs = CASES[case]
    write(str(tmp_path))
    scene = str(tmp_path / sub)
    for split in splits:
        got = getattr(t_datasets, cls)(scene, split, BATCH, **kwargs)
        want = getattr(j_datasets, cls)(scene, split, BATCH, **kwargs)
        assert got.n_images > 0
        _assert_same_dataset(got, want)
        # The readers' shared seed: the same pixels, then a train batch's
        # Pixels exactly and a test batch's host-cast rays.
        for _ in range(2):
            _assert_same_batch(got.sample_batch(), want.sample_batch(), exact=split == "train")
        _assert_same_batch(got.image_batch(got.n_images - 1),
                           want.image_batch(want.n_images - 1), exact=False)


def test_tnt_reads_the_nerfpp_layout(tmp_path):
    write_tnt(str(tmp_path))
    assert issubclass(t_datasets.TanksAndTemplesDataset, t_datasets.NerfppSceneDataset)
    got = t_datasets.TanksAndTemplesDataset(str(tmp_path), "train", BATCH)
    same = t_datasets.NerfppSceneDataset(str(tmp_path), "train", BATCH)
    for name in ("images", "camtoworlds", "pixtocams"):
        np.testing.assert_array_equal(getattr(got, name), getattr(same, name))
    assert (got.near, got.far) == (1e-4, 2.0)


@pytest.mark.parametrize("seed", range(6))
def test_decompose_projection_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[40.0 + seed, 0.5, 16.0], [0, 42.0, 12.0], [0, 0, 1.0]])
    R, t = _rotation(rng), rng.normal(size=3)
    # A negative overall scale as well: the decomposition fixes the signs.
    P = (K @ np.concatenate([R, t[:, None]], axis=1)) * (3.7 if seed % 2 else -0.8)
    got, want = t_datasets.decompose_projection(P), j_datasets.decompose_projection(P)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got[0], K, atol=1e-8)
    np.testing.assert_allclose(got[1], R, atol=1e-8)


# dataset name -> (writer, scene dir below the written root)
BUILD = {
    "blender": (write_blender, ""),
    "tnt": (write_tnt, ""),
    "tnt_fvs": (write_fvs, ""),
    "dtu": (write_dtu, "scan1"),
    "nsvf": (write_nsvf, ""),
    "rtmv": (write_rtmv, ""),
}


@pytest.mark.parametrize("name", sorted(BUILD))
def test_build_dataset_reads_every_reference_name(tmp_path, name):
    write, sub = BUILD[name]
    write(str(tmp_path))
    kw = dict(dataset=name, scene_dir=str(tmp_path / sub), batch_size=BATCH, near=0.05, far=4.0)
    for split in ("train", "test") if name != "rtmv" else ("train",):
        got = t_loop.build_dataset(TConfig(**kw), split)
        want = j_loop.build_dataset(JConfig(**kw), split)
        assert type(got).__name__ == type(want).__name__
        _assert_same_dataset(got, want)
        _assert_same_batch(got.sample_batch(), want.sample_batch(), exact=split == "train")


def test_build_dataset_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown dataset"):
        t_loop.build_dataset(TConfig(dataset="llff"), "train")
    with pytest.raises(ValueError, match="unknown dataset"):
        j_loop.build_dataset(JConfig(dataset="llff"), "train")


@pytest.mark.parametrize("ext", [".jpg", ".JPEG"])
def test_fvs_jpeg_views_raise(tmp_path, ext):
    """The port reads PNG only (no imaging library on the GPU machine): a
    Free View Synthesis scene stored as JPEG raises, naming the fix."""
    write_fvs(str(tmp_path), ext=ext)
    with pytest.raises(ValueError, match="PNG images only"):
        t_datasets.TanksAndTemplesFVSDataset(str(tmp_path), "train", BATCH)


def test_cli_trains_blender_ngp_on_cpu(capsys, tmp_path):
    """configs/blender_ngp.json through the port's CLI on a written Blender
    layout, at small widths (its own AABB, white background and losses)."""
    from outdoor_nerf_depth_torch import __main__ as t_cli

    write_blender(str(tmp_path / "scene"), n_train=6, n_test=2, h=12, w=16)
    small = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16,
                 bg_intensity_range=[1.0, 1.0],
                 field_params=dict(n_levels=2, n_features=2, log2_table_size=10,
                                   base_resolution=4, max_resolution=16, hidden_width=16,
                                   geo_features=7))
    t_cli.main(["--config", "configs/blender_ngp.json", "--device", "cpu",
                f"scene_dir={tmp_path / 'scene'}", f"exp_dir={tmp_path / 'exp'}",
                "max_steps=3", "batch_size=64", "print_every=1", "occupancy_update_every=2",
                "model_params=" + json.dumps(small)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    train_lines = [x for x in lines if "loss" in x]
    assert [x["step"] for x in train_lines] == [1, 2, 3]
    for x in train_lines:
        assert {"loss_data", "loss_distortion", "loss_opacity"} <= set(x)
        assert "loss_depth" not in x and np.isfinite(x["loss"])
    assert lines[-1]["split"] == "test" and np.isfinite(lines[-1]["mean"]["psnr"])
    assert sorted(os.listdir(tmp_path / "exp" / "checkpoints")) == ["3", "model_meta.json"]
