"""The port's C++ dataplane (`data/native_batcher.py` over its own copy of
`csrc/dataplane.cpp`) against the reference package's `NativeRayBatcher`,
on the CPU.

Every field of three consecutive batches is equal bit for bit at seeds 1
and 7 with 1, 3 and 8 threads, on a `SyntheticDataset` and on a small
KITTI-style `DrivingSceneDataset`. The port's loop takes its batches from
the dataplane under the reference loop's rule (checked on Synthetic,
Driving and NeRF++ datasets and with `use_native_batcher=False`), and a
failed build raises. The library is built under `build/`, never in
`native/`. Fault 4, shared with the reference: the dataplane casts pinhole
rays, so on a lensed driving scene its directions are the pinhole cast of
its pixels and not the lensed cast `dataset.sample_batch` leads to, in both
packages.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import native_batcher as t_native
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.tools import make_kitti_fixture as t_fixture
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu.data import cameras as j_cameras
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import native_batcher as j_native
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config
from outdoor_nerf_depth_tpu.train.loop import build_dataset as j_build_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS, HEIGHT, WIDTH = 10, 24, 80
RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "imageplane", "lossmult", "near",
              "far", "cam_idx")
# The dataplane casts in float32 C++, the port's caster in float32 torch:
# directions agree to a few ulps of their largest component.
CAST_RTOL_OF_MAX = 1e-6


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_native")
    t_fixture.main(str(root), N_VIEWS, HEIGHT, WIDTH)
    return root


def _datasets(kind, fixture_root, batch=256):
    if kind == "synthetic":
        kw = dict(global_batch_size=batch, n_images=4, height=24, width=32, seed=0)
        return (t_datasets.SyntheticDataset("train", **kw),
                j_datasets.SyntheticDataset("train", **kw))
    scene = str(fixture_root / "dtu_format")
    return (t_datasets.DrivingSceneDataset(scene, "train", batch),
            j_datasets.DrivingSceneDataset(scene, "train", batch))


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("kind", ["synthetic", "driving"])
def test_batches_equal_the_reference_bit_for_bit(fixture_root, kind, seed, threads):
    port_set, ref_set = _datasets(kind, fixture_root)
    port = t_native.NativeRayBatcher(port_set, seed=seed, num_threads=threads)
    ref = j_native.NativeRayBatcher(ref_set, seed=seed, num_threads=threads)
    for _ in range(3):
        got, want = port.sample_batch(), ref.sample_batch()
        for name in RAY_FIELDS:
            g, w = getattr(got.rays, name), np.asarray(getattr(want.rays, name))
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        for name in ("rgb", "depth_gt", "depth_sup"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert got.rays.cam_idx.shape == (port_set.batch_size, 1)
        assert got.rays.cam_idx.dtype == torch.int32


def test_no_depth_fields_where_the_dataset_has_none():
    kw = dict(global_batch_size=64, n_images=2, height=8, width=12, with_depth=False)
    batch = t_native.NativeRayBatcher(t_datasets.SyntheticDataset("train", **kw)).sample_batch()
    assert batch.depth_gt is None and batch.depth_sup is None


def test_per_image_intrinsics_are_refused(fixture_root):
    dataset = t_datasets.NerfppSceneDataset(str(fixture_root / "nerfpp"), "train", 64)
    assert dataset.pixtocams.ndim == 3
    with pytest.raises(ValueError, match="shared intrinsics"):
        t_native.NativeRayBatcher(dataset)


def _reference_rule(config, dataset):
    """The reference loop's condition (`train/loop.py`), on its objects."""
    return bool(config.use_native_batcher and getattr(dataset, "pixtocams", None) is not None
                and j_native.is_available() and dataset.pixtocams.ndim == 2)


TINY_MIP = ('model_params={"num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 2, '
            '"nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8, '
            '"net_width_viewdirs": 8, "max_deg_point": 4}, '
            '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}')


class _Stop(Exception):
    pass


@pytest.mark.parametrize("kind,native", [("synthetic", True), ("synthetic", False),
                                         ("driving", True), ("driving", False),
                                         ("nerfpp", True)])
def test_the_loop_picks_its_batches_by_the_reference_rule(fixture_root, tmp_path, monkeypatch,
                                                          kind, native):
    config_path = {"nerfpp": "configs/kitti_nerfpp.json"}.get(kind, "configs/kitti_mipnerf360.json")
    scene = {"driving": fixture_root / "dtu_format", "nerfpp": fixture_root / "nerfpp"}
    overrides = [f"exp_dir={tmp_path}", "batch_size=64", "max_steps=1",
                 f"use_native_batcher={'true' if native else 'false'}"]
    overrides += [f"dataset={kind}"] if kind == "synthetic" else [f"scene_dir={scene[kind]}"]
    if kind == "nerfpp":
        overrides.append('model_params={"cascade_samples": [4, 4], "net_depth": 2, '
                         '"net_width": 16, "pos_degrees": 4, "view_degrees": 2}')
    else:
        overrides.append(TINY_MIP)
    config_t = t_load_config(config_path, overrides)
    config_j = j_load_config(config_path, overrides)
    port_set = t_loop.build_dataset(config_t, "train")
    ref_set = j_build_dataset(config_j, "train")
    expect = _reference_rule(config_j, ref_set)
    assert t_native.applies(config_t, port_set) == expect
    assert expect == (native and kind != "nerfpp")

    picked = []

    class Capture:
        def __init__(self, make_batch):
            picked.append(make_batch)
            raise _Stop

    monkeypatch.setattr(t_loop.datasets_lib, "PrefetchIterator", Capture)
    with pytest.raises(_Stop):
        t_loop.train(config_t, device="cpu", log_fn=lambda line: None, dataset=port_set)
    owner = picked[0].__self__
    assert isinstance(owner, t_native.NativeRayBatcher) == expect
    if not expect:
        assert owner is port_set


def test_a_failed_build_raises_in_the_loop(tmp_path, monkeypatch):
    def broken(out):
        raise RuntimeError("native dataplane: g++ failed")

    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "library_path", lambda: tmp_path / "libdataplane-x.so")
    monkeypatch.setattr(t_native, "_build", broken)
    config = t_load_config("configs/kitti_mipnerf360.json",
                           [f"exp_dir={tmp_path}", "dataset=synthetic", "batch_size=64",
                            "max_steps=1", TINY_MIP])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_loop.train(config, device="cpu", log_fn=lambda line: None)


def test_the_library_is_built_under_build_not_native(tmp_path, monkeypatch):
    native_dir = os.path.join(REPO, "native")
    before = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns for f in os.listdir(native_dir)}
    path = t_native.library_path()
    assert os.path.commonpath([str(path), os.path.join(REPO, "build")]) == os.path.join(REPO,
                                                                                       "build")
    # A fresh build into a scratch copy of the build directory.
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native, "library_path", lambda: tmp_path / path.name)
    t_native.load()
    assert (tmp_path / path.name).exists()
    after = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns for f in os.listdir(native_dir)}
    assert after == before
    assert path.name.startswith("libdataplane-") and path.suffix == ".so"


def _splitmix_pixels(seed, n, n_images, height, width):
    """The dataplane's draws for one thread: (img, py, px) of each ray."""
    mask = 2**64 - 1
    state = (seed + 0x9E3779B97F4A7C15) & mask
    out = []
    for _ in range(n):
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        r = z ^ (z >> 31)
        out.append((r % n_images, (r >> 42) % height, (r >> 20) % width))
    return np.array(out)


@pytest.mark.parametrize("model", ["OPENCV", "OPENCV_FISHEYE"])
def test_fault_4_the_dataplane_drops_the_lens_in_both_packages(fixture_root, tmp_path, model):
    scene = tmp_path / "dtu_format"
    shutil.copytree(fixture_root / "dtu_format", scene)
    t_fixture.rewrite_camera(str(scene), model)
    port_set = t_datasets.DrivingSceneDataset(str(scene), "train", 128)
    ref_set = j_datasets.DrivingSceneDataset(str(scene), "train", 128)
    assert port_set.distortion is not None and ref_set.distortion is not None
    got = t_native.NativeRayBatcher(port_set, seed=3, num_threads=1).sample_batch()
    want = j_native.NativeRayBatcher(ref_set, seed=3, num_threads=1).sample_batch()
    np.testing.assert_array_equal(got.rays.directions.numpy(), np.asarray(want.rays.directions))

    # The first call's seed: seed + 1, one LCG step.
    call_seed = ((3 + 1) * 6364136223846793005 + 1442695040888963407) % 2**64
    img, py, px = _splitmix_pixels(call_seed, 128, port_set.n_images, port_set.height,
                                   port_set.width).T
    np.testing.assert_array_equal(got.rays.cam_idx[:, 0].numpy(), img)
    pixtocams, c2w = port_set.pixtocams.astype(np.float32), port_set.camtoworlds[img]
    cast = lambda dist, camtype: t_cameras.pixels_to_rays(
        torch.from_numpy(px.astype(np.float32)), torch.from_numpy(py.astype(np.float32)),
        torch.from_numpy(pixtocams), torch.from_numpy(c2w.astype(np.float32)), dist, camtype)
    pinhole = cast(None, "perspective")[1].numpy()
    lensed = cast(port_set.distortion, port_set.camtype)[1].numpy()
    scale = np.abs(pinhole).max()
    np.testing.assert_allclose(got.rays.directions.numpy(), pinhole,
                               atol=CAST_RTOL_OF_MAX * scale, rtol=0)
    lens_shift = np.abs(got.rays.directions.numpy() - lensed).max()
    assert lens_shift > 1e3 * CAST_RTOL_OF_MAX * scale
    # The reference: its lensed cast of those pixels, against its batch.
    ref_lensed = j_cameras.pixels_to_rays(
        px, py, ref_set.pixtocams, ref_set.camtoworlds[img], ref_set.distortion,
        ref_set.camtype)[1]
    assert np.abs(np.asarray(want.rays.directions) - np.asarray(ref_lensed)).max() > \
        1e3 * CAST_RTOL_OF_MAX * scale
    # Without the dataplane the loop trains on pixels, cast with the lens in the step.
    assert isinstance(port_set.sample_batch().rays, t_rays.Pixels)
