"""Render a camera path from a trained scene's checkpoint.

    python -m outdoor_nerf_depth_torch.tools.render --config exp/config.json \\
        [n_frames=60] [path=ellipse|spiral|spline|train] \\
        [render_height=H] [render_width=W] [--device cpu] [key=value ...]

The port's counterpart of the repository's `render.py`. It restores the
latest checkpoint of the config's `exp_dir`, generates an inward-facing
elliptical, a forward-facing spiral or a keyframe-spline path through the
training cameras (or takes the training poses themselves), renders each
frame's colour and depth (an NGP model through `ngp_eval_renderer`), and
writes each as an rgb|depth panel, `exp_dir/path_renders/frame_####.png`.
`render_height`/`render_width` change the pixel grid and keep the field
of view (the other side follows the aspect ratio when one is given). An
mp4 of the frames is written only when `imageio` with an ffmpeg backend is
present; otherwise the tool says so and keeps the frames. Runs on CUDA
unless `--device cpu` is given.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.tools.eval import split_flags
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import build_dataset, resolve_device, set_full_float32
from outdoor_nerf_depth_torch.utils import image as image_lib
from outdoor_nerf_depth_torch.utils import vis as vis_lib

PATHS = ("ellipse", "spiral", "spline", "train")


def camera_path(dataset, kind: str, n_frames: int) -> np.ndarray:
    """[n, 3, 4] camera-to-world poses of the path `kind` through `dataset`'s cameras."""
    poses = dataset.camtoworlds
    if kind == "ellipse":
        return cameras_lib.generate_ellipse_path(poses, n_frames=n_frames)
    if kind == "spiral":
        return cameras_lib.generate_spiral_path(poses, (dataset.near, dataset.far),
                                                n_frames=n_frames)
    if kind == "spline":
        keys = poses[:: max(1, len(poses) // 8)]
        return cameras_lib.generate_spline_path(keys, n_interp=max(1, n_frames // max(1, len(keys) - 1)))
    if kind == "train":
        return poses[:n_frames]
    raise ValueError(f"unknown path {kind!r}; expected one of {PATHS}")


def frame_batch(pose, pixtocams, height: int, width: int, near: float, far: float,
                camtype: str = "perspective") -> rays_lib.Batch:
    """The [height, width] rays of one frame seen from `pose`, cast on the host."""
    px, py = cameras_lib.pixel_grid(width, height)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pixels = rays_lib.Pixels(
        pix_x=t(px.astype(np.float32)),
        pix_y=t(py.astype(np.float32)),
        cam_idx=t(np.zeros(px.shape + (1,), np.int32)),
        lossmult=t(np.ones(px.shape + (1,), np.float32)),
        near=t(np.full(px.shape + (1,), near, np.float32)),
        far=t(np.full(px.shape + (1,), far, np.float32)),
    )
    cameras = (t(np.asarray(pixtocams, np.float32)), t(np.asarray(pose, np.float32)[None]), None)
    return rays_lib.Batch(rays=cameras_lib.cast_pixels(pixels, cameras, camtype))


def main(argv):
    """Render the path; returns {"frames": paths, "frame_ms": host ms per
    frame, "height", "width", "video": the mp4's path or None}."""
    device, cfg_path, rest = split_flags(argv)
    device = resolve_device(device)
    path_kind, n_frames = "ellipse", 60
    render_h = render_w = None
    overrides = []
    for a in rest:
        key, _, value = a.partition("=")
        if key == "path":
            path_kind = value
        elif key == "n_frames":
            n_frames = int(value)
        elif key == "render_height":
            render_h = int(value)
        elif key == "render_width":
            render_w = int(value)
        else:
            overrides.append(a)
    if path_kind not in PATHS:
        raise ValueError(f"unknown path {path_kind!r}; expected one of {PATHS}")
    config = load_config(cfg_path, overrides)
    set_full_float32()

    dataset = build_dataset(config, "train")
    height, width = dataset.height, dataset.width
    pixtocams = np.asarray(dataset.pixtocams)
    if render_h or render_w:
        # Rescale the inverse intrinsics so the field of view is kept.
        render_h = render_h or int(round(height * render_w / width))
        render_w = render_w or int(round(width * render_h / height))
        scale = np.diag([width / render_w, height / render_h, 1.0]).astype(np.float32)
        pixtocams = pixtocams @ scale
        height, width = render_h, render_w
    if hasattr(dataset, "scene_scale"):
        config = config.replace(depth_scale=float(dataset.scene_scale))
    model, step = step_lib.load_checkpoint(config)
    print(f"restored step {step}")
    model = model.to(device)

    poses = camera_path(dataset, path_kind, n_frames)
    out_dir = os.path.join(config.exp_dir, "path_renders")
    os.makedirs(out_dir, exist_ok=True)
    paths, frames, frame_ms = [], [], []
    for fi, pose in enumerate(poses):
        batch = frame_batch(pose, pixtocams, height, width, dataset.near, dataset.far,
                            dataset.camtype)
        t0 = time.perf_counter()
        rendering = step_lib.render_image(model, batch, config.render_chunk_size, device,
                                          config.ngp_eval_renderer)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        depth = rendering["distance_mean"] / config.depth_scale
        frame = vis_lib.side_by_side(rendering["rgb"], vis_lib.visualize_depth(depth))
        paths.append(os.path.join(out_dir, f"frame_{fi:04d}.png"))
        image_lib.save_img_u8(frame, paths[-1])
        frames.append(image_lib.to_u8(frame))
        print(f"frame {fi + 1}/{len(poses)}")

    video = os.path.join(out_dir, "path.mp4")
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(video, frames, fps=15, quality=8)
        print(f"wrote {video}")
    except (ImportError, ValueError, RuntimeError, OSError) as e:
        # No imageio, or no ffmpeg backend for it: the frames stay on disk.
        print(f"video stitching skipped ({e}); frames in {out_dir}")
        video = None
    return {"frames": paths, "frame_ms": frame_ms, "height": height, "width": width,
            "video": video}


if __name__ == "__main__":
    main(sys.argv[1:])
