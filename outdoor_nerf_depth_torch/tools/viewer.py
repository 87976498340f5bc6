"""Orbit-camera viewer over a trained checkpoint, and the camera-frusta plot.

    python -m outdoor_nerf_depth_torch.tools.viewer --config exp/scene/config.json \\
        [height=200] [width=300] [--device cpu] [key=value ...]
    python -m outdoor_nerf_depth_torch.tools.viewer --frusta frusta.json \\
        [--frusta-out frusta.png]

The port's counterpart of the repository's `viewer.py`. The first form
restores the latest checkpoint of the config's `exp_dir` and opens a window
that renders colour | depth from an orbit around the training cameras:
drag to orbit, scroll to zoom, arrow keys to pan. The second draws the
frusta that `data/preprocess.py:export_camera_frusta_json` writes: to a PNG
with `--frusta-out` (no GUI library needed), else in a 3-D window. The
windows need matplotlib and raise ImportError without it. Renders run on
CUDA unless `--device cpu` is given. `OrbitCamera`, `view_batch` and
`render_view` are importable and run headless.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.tools.eval import split_flags
from outdoor_nerf_depth_torch.tools.render import frame_batch
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import build_dataset, resolve_device, set_full_float32
from outdoor_nerf_depth_torch.utils import tracing
from outdoor_nerf_depth_torch.utils import vis as vis_lib

HEADLESS = ("the viewer's window needs matplotlib, which is not installed; "
            "draw the frusta to a PNG with --frusta FILE --frusta-out PNG, or render "
            "views headless with tools.viewer.render_view")


class OrbitCamera:
    """Spherical orbit camera producing OpenGL camera-to-world poses."""

    def __init__(self, center=(0.0, 0.0, 0.0), radius: float = 2.0,
                 theta: float = 0.0, phi: float = 0.0):
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.theta = float(theta)  # azimuth, radians
        self.phi = float(phi)  # elevation, radians

    def orbit(self, d_theta: float, d_phi: float):
        self.theta += d_theta
        self.phi = float(np.clip(self.phi + d_phi, -1.5, 1.5))

    def zoom(self, factor: float):
        self.radius = float(np.clip(self.radius * factor, 1e-3, 1e6))

    def pan(self, dx: float, dy: float):
        pose = self.pose()
        right, up = pose[:3, 0], pose[:3, 1]
        self.center = self.center + self.radius * (dx * right + dy * up)

    def position(self) -> np.ndarray:
        cp, sp = np.cos(self.phi), np.sin(self.phi)
        ct, st = np.cos(self.theta), np.sin(self.theta)
        return self.center + self.radius * np.array([cp * st, cp * ct, sp])

    def pose(self) -> np.ndarray:
        """[3, 4] OpenGL camera-to-world looking at the center (the camera
        looks down its -z axis)."""
        pos = self.position()
        return cameras_lib.view_matrix(pos - self.center, np.array([0.0, 0.0, 1.0]), pos)


def orbit_around(camtoworlds) -> OrbitCamera:
    """The orbit the viewer starts on: centred on the mean camera position,
    at 1.5x the largest distance from it (no less than 0.5)."""
    positions = np.asarray(camtoworlds)[:, :3, 3]
    center = positions.mean(0)
    radius = np.linalg.norm(positions - center, axis=-1).max() * 1.5
    return OrbitCamera(center=center, radius=max(radius, 0.5))


def view_batch(dataset, cam: OrbitCamera, height: int, width: int):
    """The [height, width] rays of a pinhole of focal 1.1 width at the
    orbit's pose, cast with the dataset's camera type and near/far (on the
    host; marked `view.cast` under a profiler)."""
    with tracing.span("view.cast"):
        pixtocam = cameras_lib.pinhole_pixtocam(1.1 * width, width, height).astype(np.float32)
        return frame_batch(cam.pose(), pixtocam, height, width, dataset.near, dataset.far,
                           dataset.camtype)


def render_view(config, dataset, model, cam: OrbitCamera, height: int, width: int, device=None):
    """(colour | depth panel, the rendering) of the orbit's view through
    `render_image` in chunks of `config.render_chunk_size` (an NGP model
    marching through the grid it carries, by `config.ngp_eval_renderer`)."""
    rendering = step_lib.render_image(model, view_batch(dataset, cam, height, width),
                                      config.render_chunk_size, device, config.ngp_eval_renderer)
    depth = rendering["distance_mean"] / config.depth_scale
    return vis_lib.side_by_side(rendering["rgb"], vis_lib.visualize_depth(depth)), rendering


def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(HEADLESS) from e
    return plt


def show_frusta(frusta_json: str, out_png=None):
    """Draw the exported frusta to `out_png`, or in a 3-D window without it."""
    if out_png is not None:
        vis_lib.plot_camera_frusta(frusta_json, out_png)
        print(f"wrote {out_png}")
        return
    plt = _pyplot()
    with open(frusta_json) as f:
        segments, colours = vis_lib.frusta_segments(json.load(f)["frusta"])
    ax = plt.figure(figsize=(8, 8)).add_subplot(projection="3d")
    for seg, colour in zip(segments, colours):
        ax.plot(*seg.T, color=np.asarray(colour) / 255.0, lw=0.5)
    ax.set_box_aspect((1, 1, 1))
    plt.show()


def _window(cam: OrbitCamera, render):
    """The interactive orbit around `cam`; `render()` gives the panel of its view."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    im = ax.imshow(render())
    ax.set_axis_off()
    drag = {"xy": None}

    def refresh():
        im.set_data(render())
        fig.canvas.draw_idle()

    def on_press(e):
        drag["xy"] = (e.x, e.y)

    def on_release(e):
        if drag["xy"] is not None:
            dx, dy = e.x - drag["xy"][0], e.y - drag["xy"][1]
            cam.orbit(-0.01 * dx, 0.01 * dy)
            drag["xy"] = None
            refresh()

    def on_scroll(e):
        cam.zoom(0.9 if e.button == "up" else 1.1)
        refresh()

    def on_key(e):
        step_size = 0.05
        moves = {"left": (-step_size, 0), "right": (step_size, 0),
                 "up": (0, step_size), "down": (0, -step_size)}
        if e.key in moves:
            cam.pan(*moves[e.key])
            refresh()

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("scroll_event", on_scroll)
    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()


def main(argv):
    device, cfg_path, rest = split_flags(argv)
    height, width, frusta_json, frusta_png, overrides = 200, 300, None, None, []
    it = iter(rest)
    for a in it:
        if a == "--frusta":
            frusta_json = next(it)
        elif a == "--frusta-out":
            frusta_png = next(it)
        elif a.startswith("height="):
            height = int(a.split("=")[1])
        elif a.startswith("width="):
            width = int(a.split("=")[1])
        else:
            overrides.append(a)
    if frusta_json is not None:
        show_frusta(frusta_json, frusta_png)
        return
    device = resolve_device(device)
    _pyplot()  # no window library: raise before the checkpoint loads
    config = load_config(cfg_path, overrides)
    set_full_float32()
    dataset = build_dataset(config, "train")
    if hasattr(dataset, "scene_scale"):
        config = config.replace(depth_scale=float(dataset.scene_scale))
    model, step = step_lib.load_checkpoint(config)
    print(f"restored step {step}")
    model = model.to(device)
    cam = orbit_around(dataset.camtoworlds)
    _window(cam, lambda: render_view(config, dataset, model, cam, height, width, device)[0])


if __name__ == "__main__":
    main(sys.argv[1:])
