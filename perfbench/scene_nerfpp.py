"""The analytic driving scene written in the NeRF++ per-image txt layout.

The same views as the DTU_format scene of `perfbench/scene.py` (its objects,
camera path, intrinsics, ray caster and PNG codes, so the pixels and depth
codes are exactly those cells'), laid out as NeRF++'s preprocessing writes a
KITTI sequence:

  <dir>/{train,test}/intrinsics/####.txt   the 4x4 intrinsics, one row of 16
  <dir>/{train,test}/pose/####.txt         OpenCV camera-to-world, one row of 16
  <dir>/{train,test}/rgb/####.png          uint8 RGB
  <dir>/{train,test}/depth/####.png        uint16 metres*256 (0: no return)
  <dir>/{train,test}/min_depth/####.png    uint8 zeros (no per-ray near bound)
  <dir>/scale                              metres to normalized units

The camera centres are moved to their mean and scaled by 1 / (1.1 x the
largest distance from it), as nerfplusplus's `normalize_cam_dict.py` and the
port's `tools/make_kitti_fixture.py` do, so every camera lies inside the
unit sphere. Every 10th view from index 9 is held out (`test`), as in the
DTU_format cells. The port's `NerfppSceneDataset` reads it back.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from perfbench import scene as scene_lib

SCENE_FORMAT = 1  # bump when the written layout changes


def normalization(c2ws: np.ndarray):
    """(centre, scale) of the camera centres: scale = 1 / (1.1 x largest distance)."""
    centers = c2ws[:, :3, 3].astype(np.float64)
    center = centers.mean(0)
    radius = float(np.max(np.linalg.norm(centers - center, axis=-1))) * 1.1
    return center, 1.0 / radius


def write_scene(out_dir: str, params: dict):
    """Render and write the scene into `out_dir` (made afresh)."""
    objects = scene_lib.make_objects(params["object_seed"], params["n_objects"])
    c2ws = scene_lib.camera_path(params["n_views"], params["step_m"])
    k = scene_lib.intrinsics(params)
    pixtocam = np.linalg.inv(k)
    h, w = params["height"], params["width"]
    center, scale = normalization(c2ws)
    k4 = np.eye(4)
    k4[:3, :3] = k
    held_out = set(range(9, params["n_views"], 10))
    for split in ("train", "test"):
        for sub in ("intrinsics", "pose", "rgb", "depth", "min_depth"):
            os.makedirs(os.path.join(out_dir, split, sub))
    zeros = np.zeros((h, w), np.uint8)
    for i, c2w in enumerate(c2ws):
        rgb, depth = scene_lib.trace(c2w, pixtocam, h, w, near=params["trace_near"], **objects)
        split = os.path.join(out_dir, "test" if i in held_out else "train")
        stem = f"{i:04d}"
        c2w_cv = np.eye(4)
        c2w_cv[:3, :3] = c2w[:3, :3].astype(np.float64) @ scene_lib.OPENCV_TO_OPENGL3
        c2w_cv[:3, 3] = (c2w[:3, 3] - center) * scale
        np.savetxt(os.path.join(split, "intrinsics", stem + ".txt"), k4.reshape(1, 16))
        np.savetxt(os.path.join(split, "pose", stem + ".txt"), c2w_cv.reshape(1, 16))
        images = {"rgb": scene_lib.rgb_codes(rgb), "depth": scene_lib.depth_codes(depth),
                  "min_depth": zeros}
        for sub, image in images.items():
            with open(os.path.join(split, sub, stem + ".png"), "wb") as f:
                f.write(scene_lib.encode_png(image))
    with open(os.path.join(out_dir, "scale"), "w") as f:
        f.write(f"{scale!r}\n")


def ensure_scene(cache_root: str, params: dict) -> str:
    """The scene's directory under `cache_root`, written first if it is missing.

    Keyed apart from the DTU_format scene of the same parameters, and
    written into a sibling directory and renamed, so a run cut off while
    writing leaves no half scene behind."""
    key = scene_lib.scene_key({"nerfpp_format": SCENE_FORMAT, **params})
    final = os.path.join(cache_root, f"scene-nerfpp-{key}")
    if os.path.isdir(final):
        return final
    os.makedirs(cache_root, exist_ok=True)
    partial = final + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    write_scene(partial, params)
    os.replace(partial, final)
    return final
