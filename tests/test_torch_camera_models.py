"""The port's lens-distorted and fisheye cameras against the reference
package on the CPU: `pixels_to_rays` for every COLMAP camera model the
COLMAP reader maps to a distortion (SIMPLE_RADIAL, RADIAL, OPENCV,
OPENCV_FISHEYE), against the reference's cast both in jnp and in numpy; the
fisheye map's NaN where a pixel centre sits on the principal point, in the
same place; and a `DrivingSceneDataset` on the KITTI fixture whose camera
is rewritten with a lens: its host-cast rays, and one mip train step that
casts its pixels inside the step, against the reference's."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import colmap as t_colmap
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.tools import make_kitti_fixture as t_fixture
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import cameras as j_cameras
from outdoor_nerf_depth_tpu.data import colmap as j_colmap
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

MODELS = sorted(t_fixture.LENS_COEFFS)
# The Newton inversion runs 10 float32 steps; the reference's CPU kernels
# contract multiply-adds into FMAs and PyTorch's do not, so the two differ
# by a few float32 ulps: relative 1e-6 (of the largest component).
RTOL = 1e-6
N_VIEWS, HEIGHT, WIDTH = 10, 24, 80
NAMES = ("origins", "directions", "viewdirs", "radii", "imageplane")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_lens")
    t_fixture.main(str(root), N_VIEWS, HEIGHT, WIDTH)
    return root


def _lens_scene(fixture_root, tmp_path, model):
    """A copy of the fixture's driving layout with its camera rewritten."""
    scene = tmp_path / "dtu_format"
    shutil.copytree(fixture_root / "dtu_format", scene)
    t_fixture.rewrite_camera(str(scene), model)
    return scene


def _wide_camera(model, width=64, height=40, focal=30.0):
    """A wide COLMAP camera of `model` (normalized coordinates up to ~1.1)
    with the fixture tool's lens coefficients."""
    coeffs = t_fixture.LENS_COEFFS[model]
    focal_params = (focal,) if model in ("SIMPLE_RADIAL", "RADIAL") else (focal, focal * 1.05)
    params = np.array(focal_params + (width / 2 - 0.3, height / 2 + 0.2) + coeffs)
    return t_colmap.Camera(1, model, width, height, params)


def _distortion_from_file(tmp_path, cam):
    """(port, reference) results of `load_scene` on a one-view model holding `cam`."""
    sparse = tmp_path / "sparse"
    sparse.mkdir(exist_ok=True)
    image = t_colmap.Image(image_id=1, qvec=np.array([1.0, 0, 0, 0]), tvec=np.zeros(3),
                           camera_id=1, name="0000.png", xys=np.zeros((0, 2)),
                           point3d_ids=np.zeros((0,), np.int64))
    t_colmap.write_cameras_bin({1: cam}, str(sparse / "cameras.bin"))
    t_colmap.write_images_bin({1: image}, str(sparse / "images.bin"))
    t_colmap.write_points3d_bin({}, str(sparse / "points3D.bin"))
    return t_colmap.load_scene(str(sparse)), j_colmap.load_scene(str(sparse))


def _pixel_cast(pixtocam, c2w, distortion, camtype, height, width):
    """The port's cast and the reference's in jnp and in numpy, of every
    pixel of a [height, width] image."""
    px, py = (a.astype(np.float32) for a in np.meshgrid(np.arange(width), np.arange(height)))
    got = t_cameras.pixels_to_rays(torch.from_numpy(px), torch.from_numpy(py),
                                   torch.from_numpy(pixtocam), torch.from_numpy(c2w),
                                   distortion=distortion, camtype=camtype)
    cast = jax.jit(lambda x, y, p, c: j_cameras.pixels_to_rays(
        x, y, p, c, distortion=distortion, camtype=camtype, xnp=jnp))
    want_jnp = cast(px, py, pixtocam, c2w)
    with np.errstate(invalid="ignore", divide="ignore"):
        want_np = j_cameras.pixels_to_rays(px, py, pixtocam, c2w, distortion=distortion,
                                           camtype=camtype, xnp=np)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want_jnp],
            [np.asarray(w) for w in want_np])


def _assert_close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {name}")
        # A radius is the distance between neighbouring pixels' directions:
        # it keeps their absolute rounding, so it is held on their scale.
        scale = np.nanmax(np.abs(want[1] if name == "radii" else w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale, equal_nan=True,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("model", MODELS)
def test_pixels_to_rays_matches_the_reference(tmp_path, model):
    cam = _wide_camera(model)
    (names, poses, pixtocam, dist_t, camtype_t, _), (_, _, pixtocam_j, dist_j, camtype_j, _) = (
        _distortion_from_file(tmp_path, cam))
    assert dist_t == dist_j and camtype_t == camtype_j
    assert (camtype_t == "fisheye") == (model == "OPENCV_FISHEYE")
    np.testing.assert_array_equal(pixtocam, pixtocam_j)
    c2w = poses[0][:3, :4].astype(np.float32)
    c2w[:3, 3] = [0.3, -1.2, 2.0]
    got, want_jnp, want_np = _pixel_cast(pixtocam.astype(np.float32), c2w, dist_t, camtype_t,
                                         cam.height, cam.width)
    assert np.isfinite(np.stack(got[1])).all()
    _assert_close(got, want_jnp, "jnp")
    _assert_close(got, want_np, "numpy")
    # The lens does move the rays: the same camera without it differs.
    plain = t_cameras.pixels_to_rays(*(torch.from_numpy(a) for a in (
        *np.meshgrid(np.arange(cam.width, dtype=np.float32),
                     np.arange(cam.height, dtype=np.float32)),
        pixtocam.astype(np.float32), c2w)))
    assert np.abs(plain[2].numpy() - got[2]).max() > 1e-3


@pytest.mark.parametrize("distorted", [False, True])
def test_fisheye_nan_on_the_principal_point_as_the_reference(distorted):
    """theta = 0 at a pixel centre on the principal point: the reference
    divides sin(theta) by theta unguarded, and so does the port."""
    width, height, focal = 7, 5, 32.0  # centre pixel (3, 2) is (3.5, 2.5)
    pixtocam = np.array([[1 / focal, 0, -3.5 / focal], [0, 1 / focal, -2.5 / focal],
                         [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    dist = dict(zip(("k1", "k2", "k3", "k4"), t_fixture.LENS_COEFFS["OPENCV_FISHEYE"])) \
        if distorted else None
    got, want_jnp, want_np = _pixel_cast(pixtocam, c2w, dist, "fisheye", height, width)
    nan = np.isnan(got[1]).any(-1)
    assert nan[2, 3] and nan.sum() == 1
    _assert_close(got, want_jnp, "jnp")
    _assert_close(got, want_np, "numpy")


def _to_torch(obj):
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


@pytest.mark.parametrize("model", MODELS)
def test_driving_dataset_with_a_lens_matches_the_reference(fixture_root, tmp_path, model):
    scene = str(_lens_scene(fixture_root, tmp_path, model))
    for split in ("train", "test"):
        got = t_datasets.DrivingSceneDataset(scene, split, 64)
        want = j_datasets.DrivingSceneDataset(scene, split, 64)
        assert got.distortion == want.distortion and got.distortion is not None
        assert got.camtype == want.camtype
        for name in ("images", "camtoworlds", "pixtocams", "depth_gt", "depth_sup"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        g, w = got.image_batch(0).rays, want.image_batch(0).rays
        _assert_close([getattr(g, n).numpy() for n in NAMES],
                      [getattr(w, n) for n in NAMES], f"{split} image_batch")


MIP_SMALL = [
    "batch_size=64", "max_steps=3", "lr_delay_steps=0", "randomized=false", "exp_dir=unused",
    'model_params={"num_prop_samples": 16, "num_nerf_samples": 8, "num_levels": 3, '
    '"raydist_fn": "reciprocal", "opaque_background": true, "single_jitter": true, '
    '"nerf_mlp_params": {"net_depth": 3, "net_width": 32, "bottleneck_width": 16, '
    '"net_width_viewdirs": 16, "max_deg_point": 4}, '
    '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}',
]


@pytest.mark.parametrize("model", ["OPENCV", "OPENCV_FISHEYE"])
def test_mip_step_casts_a_lens_in_the_step_as_the_reference(fixture_root, tmp_path, model):
    scene = str(_lens_scene(fixture_root, tmp_path, model))
    dataset = j_datasets.DrivingSceneDataset(scene, "train", 64)
    batch = dataset.sample_batch()
    assert type(batch.rays).__name__ == "Pixels"  # cast inside the step
    overrides = MIP_SMALL + [f"scene_dir={scene}", f"depth_scale={dataset.scene_scale}"]
    config_j = j_load_config("configs/kitti_mipnerf360.json", overrides)
    config_t = t_load_config("configs/kitti_mipnerf360.json", overrides)
    assert config_t.cast_rays_in_train_step and config_t.lambda_depth > 0
    mesh = parallel.make_mesh(jax.devices()[:1])
    model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    state, stats_j = step_j(state, parallel.shard_batch(batch, mesh), jax.random.PRNGKey(0), 0.0)
    params_j = {n: p.detach().numpy() for n, p in convert.params_from_flax(
        jax.device_get(state.params), t_step.build_model(config_t)).named_parameters()}

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    port_set = t_datasets.DrivingSceneDataset(scene, "train", 64)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn,
                                    cameras=port_set.cameras_on("cpu"), camtype=port_set.camtype)
    stats_t = step_t(_to_torch(batch), 0, 0.0, None)
    # As the flagship step test holds them (tests/test_torch_train_step.py):
    # losses on resampled edges at relative 3e-5, weights at 2e-5 + 1e-5.
    assert set(stats_t["loss_terms"]) == set(stats_j["loss_terms"])
    for k, v in stats_j["loss_terms"].items():
        np.testing.assert_allclose(float(stats_t["loss_terms"][k]), float(v), rtol=3e-5,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]),
                               rtol=1e-4)
    for name, p in model_t.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params_j[name], atol=2e-5, rtol=1e-5,
                                   err_msg=name)
