"""The port's orbit viewer and camera-frusta plot against the reference on
the CPU: `OrbitCamera` against the root `viewer.py`'s to 1e-12 (positions,
poses, and after the same orbit, zoom and pan calls, clamps included),
`render_view` against the reference's `_render` on the same Flax weights of
a tiny mip model (rgb and depth at 2e-5, depth also at relative 1e-4, the
tolerances of `test_torch_train_step.py::test_render_image_matches`), the frusta plot's segment
endpoints against matplotlib's own projection of the reference figure
(within 1.5 px at 960x960), the `--frusta --frusta-out` CLI, and the GUI
paths raising without matplotlib."""

import io
import json
import sys

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402

import viewer as j_viewer  # noqa: E402
from outdoor_nerf_depth_torch import convert  # noqa: E402
from outdoor_nerf_depth_torch.data import datasets as t_datasets  # noqa: E402
from outdoor_nerf_depth_torch.data import png  # noqa: E402
from outdoor_nerf_depth_torch.tools import viewer as t_viewer  # noqa: E402
from outdoor_nerf_depth_torch.train import step as t_step  # noqa: E402
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config  # noqa: E402
from outdoor_nerf_depth_torch.utils import vis as t_vis  # noqa: E402
from outdoor_nerf_depth_tpu import parallel  # noqa: E402
from outdoor_nerf_depth_tpu.data import datasets as j_datasets  # noqa: E402
from outdoor_nerf_depth_tpu.data import rays as j_rays  # noqa: E402
from outdoor_nerf_depth_tpu.train import step as j_step  # noqa: E402
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config  # noqa: E402
from outdoor_nerf_depth_tpu.utils import vis as j_vis  # noqa: E402

torch.set_num_threads(1)

POSE_TOL = 1e-12
# Distances come through an inverse CDF: 2e-5 absolute and 1e-4 relative,
# as the flagship's render_image test holds them.
RENDER_TOL, DEPTH_RTOL = 2e-5, 1e-4
FRUSTA_PX_TOL = 1.5
TINY_MIP = json.dumps({
    "num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 2,
    "bg_intensity_range": [0.0, 0.0],
    "nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8,
                        "net_width_viewdirs": 8, "max_deg_point": 4},
    "prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}})
VIEW_OVERRIDES = [f"model_params={TINY_MIP}", "render_chunk_size=64"]


def _cameras(center, radius, theta, phi):
    return (t_viewer.OrbitCamera(center, radius, theta, phi),
            j_viewer.OrbitCamera(center, radius, theta, phi))


def _same(t_cam, j_cam):
    np.testing.assert_allclose(t_cam.position(), j_cam.position(), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(t_cam.pose(), j_cam.pose(), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(t_cam.center, j_cam.center, rtol=0, atol=POSE_TOL)
    assert (t_cam.radius, t_cam.theta, t_cam.phi) == (j_cam.radius, j_cam.theta, j_cam.phi)


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0), (1.0, -2.0, 3.5), (-40.0, 12.0, 0.25)])
@pytest.mark.parametrize("radius", [0.5, 3.0, 250.0])
def test_orbit_camera_poses_match(center, radius):
    for theta in np.linspace(-3.5, 3.5, 8):
        for phi in np.linspace(-1.5, 1.5, 7):
            _same(*_cameras(center, radius, theta, phi))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orbit_camera_moves_match(seed):
    """The same orbit, zoom and pan calls on both: phi clamped to +-1.5, the
    radius to [1e-3, 1e6]."""
    rng = np.random.default_rng(seed)
    t_cam, j_cam = _cameras(rng.normal(size=3), 2.0, 0.3, 0.1)
    moves = [("orbit", (0.0, 10.0)), ("orbit", (-0.7, -20.0)), ("zoom", (1e-9,)),
             ("zoom", (1e12,)), ("zoom", (0.9,))]
    moves += [(name, tuple(rng.normal(size=n) * scale)) for name, n, scale in
              [("orbit", 2, 0.5), ("pan", 2, 0.05), ("zoom", 1, 0.0), ("pan", 2, 0.3)] * 5]
    for name, args in moves:
        if name == "zoom" and args == (0.0,):
            args = (float(rng.uniform(0.5, 1.5)),)
        getattr(t_cam, name)(*args)
        getattr(j_cam, name)(*args)
        _same(t_cam, j_cam)
    assert -1.5 <= t_cam.phi <= 1.5 and 1e-3 <= t_cam.radius <= 1e6


def test_orbit_around_the_training_cameras():
    """As the root viewer's `main` places it: the mean camera position, 1.5x
    the farthest camera's distance from it, no less than 0.5."""
    dataset = t_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    cam = t_viewer.orbit_around(dataset.camtoworlds)
    positions = dataset.camtoworlds[:, :3, 3]
    np.testing.assert_array_equal(cam.center, positions.mean(0))
    assert cam.radius == max(np.linalg.norm(positions - positions.mean(0), axis=-1).max() * 1.5,
                             0.5)
    near = np.repeat(np.eye(4)[None, :3], 3, axis=0)
    assert t_viewer.orbit_around(near).radius == 0.5


def _flax_variables(model_j, seed):
    """Seeded random Flax variables of the model's shapes (no init compile):
    He-normal kernels, biases of 0.1 standard deviation."""
    shapes = jax.eval_shape(lambda k: model_j.init(k, rng=None, rays=j_rays.dummy_rays((8,)),
                                                   train_frac=1.0, compute_extras=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    scale = lambda s: np.sqrt(2.0 / s.shape[0]) if len(s.shape) == 2 else 0.1
    return jax.tree_util.tree_map(
        lambda s: (scale(s) * rng.normal(size=s.shape)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def views():
    """The reference's `_render` and the port's `render_view` of two orbit
    poses at 12x20 (rays in 4 chunks), with the rgb and depth each drew."""
    config_j = j_load_config("configs/kitti_mipnerf360.json", ["dataset=synthetic"]
                             + VIEW_OVERRIDES)
    config_t = t_load_config("configs/kitti_mipnerf360.json", ["dataset=synthetic"]
                             + VIEW_OVERRIDES)
    model_j = j_step.build_model(config_j)
    variables = _flax_variables(model_j, 3)
    model_t = convert.params_from_flax(variables, t_step.build_model(config_t))
    dataset_j = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    dataset_t = t_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    mesh = parallel.make_mesh(jax.devices()[:1])
    render_chunk = j_step.make_render_fn(config_j, model_j, mesh)
    out = []
    for theta, phi in ((0.4, 0.2), (-2.0, -0.6)):
        t_cam, j_cam = _cameras(dataset_t.camtoworlds[:, :3, 3].mean(0), 2.5, theta, phi)
        drawn = {}
        depth_of, side_of = j_vis.visualize_depth, j_vis.side_by_side

        def visualize_depth(depth, *args, **kwargs):
            drawn["depth"] = np.asarray(depth)
            return depth_of(depth, *args, **kwargs)

        def side_by_side(rgb, *rest):
            drawn["rgb"] = np.asarray(rgb)
            return side_of(rgb, *rest)

        with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
            mp.setattr(j_vis, "visualize_depth", visualize_depth)
            mp.setattr(j_vis, "side_by_side", side_by_side)
            panel_j = j_viewer._render(config_j, dataset_j, render_chunk, variables, mesh, j_cam,
                                       12, 20)
        panel_t, rendering = t_viewer.render_view(config_t, dataset_t, model_t, t_cam, 12, 20,
                                                  "cpu")
        out.append((drawn, panel_j, panel_t, rendering, config_t))
    return out


@pytest.mark.parametrize("view", [0, 1])
def test_render_view_matches_the_reference(views, view):
    drawn, panel_j, panel_t, rendering, config = views[view]
    assert panel_t.shape == panel_j.shape == (12, 2 * 20 + 2, 3)
    np.testing.assert_allclose(rendering["rgb"], drawn["rgb"], rtol=RENDER_TOL, atol=RENDER_TOL)
    depth = rendering["distance_mean"] / config.depth_scale
    np.testing.assert_allclose(depth, drawn["depth"], rtol=DEPTH_RTOL, atol=RENDER_TOL)
    assert np.array_equal(panel_t, t_vis.side_by_side(rendering["rgb"],
                                                      t_vis.visualize_depth(depth)))
    # The rays were cast from the orbit's pose, so the views differ.
    assert float(np.std(rendering["rgb"])) > 0


def test_render_view_equals_render_image_on_its_rays(views):
    *_, rendering, config = views[0]
    dataset = t_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    cam = t_viewer.OrbitCamera(dataset.camtoworlds[:, :3, 3].mean(0), 2.5, 0.4, 0.2)
    batch = t_viewer.view_batch(dataset, cam, 12, 20)
    np.testing.assert_array_equal(batch.rays.origins[0, 0].numpy(),
                                  cam.pose()[:3, 3].astype(np.float32))
    assert batch.rays.origins.shape == (12, 20, 3)


def _frusta(seed, n):
    """n frusta at random places, each an apex and 4 corners about 0.3 away."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        apex = rng.normal(size=3) * rng.uniform(0.5, 20.0)
        corners = apex + rng.normal(size=(4, 3)) * 0.3 + rng.normal(size=3) * 0.5
        out.append({"name": f"im{i}.png", "corners": np.vstack([apex, corners]).tolist()})
    return out


def _matplotlib_endpoints(frusta):
    """The reference figure's segment endpoints in its 960x960 PNG's pixels
    (x right, y down): matplotlib's projection, then its data transform."""
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for fr in frusta:
        c = np.asarray(fr["corners"])
        for i in range(1, 5):
            j = 1 + (i % 4)
            ax.plot(*np.stack([c[0], c[i]]).T, "b-", lw=0.5)
            ax.plot(*np.stack([c[i], c[j]]).T, "r-", lw=0.5)
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(io.BytesIO(), dpi=120)  # draws the figure as the reference saves it
    segments, _ = t_vis.frusta_segments(frusta)
    xs, ys, _ = proj3d.proj_transform(*segments.reshape(-1, 3).T, ax.get_proj())
    display = ax.transData.transform(np.column_stack([xs, ys])) * (120 / fig.dpi)
    plt.close(fig)
    return np.column_stack([display[:, 0], 960 - display[:, 1]]).reshape(-1, 2, 2)


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 12), (2, 40)])
def test_frusta_endpoints_match_matplotlib(tmp_path, seed, n):
    frusta = _frusta(seed, n)
    src = tmp_path / "frusta.json"
    src.write_text(json.dumps({"frusta": frusta}))
    got = t_vis.plot_camera_frusta(str(src), str(tmp_path / "frusta.png"))
    want = _matplotlib_endpoints(frusta)
    assert got.shape == want.shape == (8 * n, 2, 2)
    assert np.abs(got - want).max() < FRUSTA_PX_TOL
    image = png.read_png(str(tmp_path / "frusta.png"))
    # Each segment's endpoints are drawn in its colour (unless a later
    # segment crosses them): most of them.
    _, colours = t_vis.frusta_segments(frusta)
    hits = [np.array_equal(image[int(y), int(x)], c) for (p, c) in zip(got, colours)
            for x, y in p if 0 <= x < 960 and 0 <= y < 960]
    assert np.mean(hits) > 0.6


def test_frusta_cli_writes_the_png(tmp_path, capsys):
    corners = [[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]]
    frusta = {"frusta": [{"name": f"im{i}.png",
                          "corners": [[c[0] + i, c[1], c[2]] for c in corners]}
                         for i in range(3)]}
    src, out = tmp_path / "frusta.json", tmp_path / "frusta.png"
    src.write_text(json.dumps(frusta))
    t_viewer.main(["--frusta", str(src), "--frusta-out", str(out)])
    assert f"wrote {out}" in capsys.readouterr().out
    image = png.read_png(str(out))
    assert image.shape == (960, 960, 3) and image.dtype == np.uint8
    blue = np.all(image == [0, 0, 255], axis=-1).sum()
    red = np.all(image == [255, 0, 0], axis=-1).sum()
    white = np.all(image == 255, axis=-1).sum()
    assert blue > 100 and red > 100 and white + blue + red == 960 * 960


@pytest.mark.parametrize("argv", [["--frusta", "FRUSTA"], ["--config", "x.json"]])
def test_windows_raise_without_matplotlib(tmp_path, monkeypatch, argv):
    """The interactive windows import matplotlib when they open and name the
    headless route when it is missing (the render route checks before it
    loads any checkpoint)."""
    src = tmp_path / "frusta.json"
    src.write_text(json.dumps({"frusta": _frusta(0, 1)}))
    argv = [str(src) if a == "FRUSTA" else a for a in argv] + ["--device", "cpu"]
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="--frusta-out"):
        t_viewer.main(argv)
