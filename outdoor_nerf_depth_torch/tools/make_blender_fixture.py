"""Write a Blender-layout (Synthetic-NeRF) scene, so configs/blender_ngp.json trains on it.

    python -m outdoor_nerf_depth_torch.tools.make_blender_fixture <out_dir> \\
        [n_train=100] [n_test=4] [size=800]

The layout of the Synthetic-NeRF scenes: `transforms_{train,test}.json`
(`camera_angle_x` 0.6911, one `transform_matrix` per frame, OpenGL axes)
and `{train,test}/r_<i>.png`, 8-bit RGBA of `size` x `size`. The scene is
the analytic sphere scene of `data/datasets.py:trace_sphere_scene` without
its ground: eight shaded spheres inside the [-0.5, 0.5]^3 box of the
config's `scale` 0.5, alpha 255 where a ray hits a sphere and 0 elsewhere.
The cameras sit on the upper hemisphere at radius 2.6, looking at the
origin, so the whole box lies within the config's `far` of 4.0. Views are
traced in a pool of threads (numpy releases the GIL in its array loops).
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.data.datasets import trace_sphere_scene

CAMERA_ANGLE_X = 0.6911112070083618
RADIUS = 2.6
NEAR = 0.05
WORKERS = 8  # threads tracing views


def make_scene(seed: int = 5):
    """Eight spheres inside [-0.45, 0.45]^3 and the light direction."""
    rng = np.random.default_rng(seed)
    n = 8
    radii = rng.uniform(0.08, 0.18, n).astype(np.float32)
    centers = (rng.uniform(-1.0, 1.0, (n, 3)) * (0.45 - radii[:, None])).astype(np.float32)
    colors = rng.uniform(0.15, 0.95, (n, 3)).astype(np.float32)
    light = np.array([0.4, 0.3, 0.866], np.float32)
    return dict(centers=centers, radii=radii, colors=colors,
                light=light / np.linalg.norm(light))


def camera_poses(n: int, seed: int):
    """OpenGL camera-to-world [n, 4, 4] on the upper hemisphere, looking at 0."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        azimuth = rng.uniform(0.0, 2 * np.pi)
        elevation = np.arcsin(rng.uniform(0.1, 0.95))
        pos = RADIUS * np.array([np.cos(elevation) * np.cos(azimuth),
                                 np.cos(elevation) * np.sin(azimuth), np.sin(elevation)])
        # view_matrix's third column points back from the view direction.
        c2w = cameras_lib.view_matrix(pos, np.array([0.0, 0.0, 1.0]), pos)
        poses.append(np.concatenate([c2w, [[0.0, 0.0, 0.0, 1.0]]], axis=0))
    return np.stack(poses)


def render_rgba(c2w, size: int, scene) -> np.ndarray:
    """One view as 8-bit RGBA: the shaded spheres, alpha = hit."""
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    pixtocam = cameras_lib.pinhole_pixtocam(focal, size, size).astype(np.float32)
    # No ground: a disk of radius 0 is never hit (its albedo divides by 0).
    with np.errstate(divide="ignore", invalid="ignore"):
        rgb, depth = trace_sphere_scene(c2w[:3, :4].astype(np.float32), pixtocam, size, size,
                                        NEAR, ground_z=0.0, ground_r=0.0, **scene)
    alpha = (depth > 0).astype(np.float32)[..., None]
    return (np.concatenate([rgb, alpha], -1) * 255.0 + 0.5).astype(np.uint8)


def main(out_dir: str, n_train: int = 100, n_test: int = 4, size: int = 800):
    scene = make_scene()
    for split, n, seed in (("train", n_train, 1), ("test", n_test, 2)):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        poses = camera_poses(n, seed)

        def write(i):
            png.write_png(os.path.join(out_dir, split, f"r_{i}.png"),
                          render_rgba(poses[i], size, scene))

        with ThreadPoolExecutor(WORKERS) as pool:
            list(pool.map(write, range(n)))
        frames = [{"file_path": f"./{split}/r_{i}", "transform_matrix": poses[i].tolist()}
                  for i in range(n)]
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f, indent=1)
    print(f"Blender layout written: {out_dir} ({n_train} train and {n_test} test views of "
          f"{size}x{size})")


if __name__ == "__main__":
    if not 2 <= len(sys.argv) <= 5:
        raise SystemExit(__doc__.split("\n\n")[1])
    main(sys.argv[1], *(int(a) for a in sys.argv[2:]))
