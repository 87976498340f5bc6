"""The data layer, checked on its own: each train batch the program drew
against the written scene.

The reference reads the scene's own files (the COLMAP model and the PNGs
the benchmark wrote), normalizes the poses as the port's driving reader
does (a frozen copy of its PCA normalization), and for every ray of a
batch finds the pixel its direction passes through in its camera, then
casts that pixel's pinhole ray itself. A ray counts as wrong when its
pixel is not a pixel centre, when its colour or depth is not that pixel's
(exactly: both sides decode the same integer codes), or when its origin,
direction or view direction is off by more than float32 cast error (1e-5
relative), or its cone radius by more than 1e-3 relative.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from perfbench import scene as scene_lib

RAY_RTOL = 1e-5
# A cone radius is a difference of neighbouring directions 1/f apart, so it
# carries f times the directions' relative round-off.
RADIUS_RTOL = 1e-3
OPENCV_TO_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])


def _quaternion_to_rotation(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def read_poses(sparse_dir: str):
    """(names, OpenGL camera-to-world [N, 4, 4]) from images.bin, by name."""
    names, poses = [], []
    with open(os.path.join(sparse_dir, "images.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            vals = struct.unpack("<i7d", f.read(60))
            f.read(4)
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n_pts)
            w2c = np.eye(4)
            w2c[:3, :3] = _quaternion_to_rotation(np.array(vals[1:5]))
            w2c[:3, 3] = vals[5:8]
            names.append(name.decode())
            poses.append(np.linalg.inv(w2c) @ OPENCV_TO_OPENGL)
    order = np.argsort(names)
    return [names[i] for i in order], np.stack(poses)[order]


def _pad(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def normalize_poses_pca(poses):
    """Principal axes of the camera positions to XYZ, fitted to the unit cube."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    centered = t - t_mean
    eigval, eigvec = np.linalg.eig(centered.T @ centered)
    rot = np.real(eigvec[:, np.argsort(eigval)[::-1]]).T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1.0, 1.0, -1.0]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    new_poses = (_pad(transform[None])[0] @ _pad(poses))[:, :3, :4]
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if new_poses.mean(axis=0)[2, 1] < 0:
        new_poses = np.diag([1.0, -1.0, -1.0]) @ new_poses
        transform = np.diag([1.0, -1.0, -1.0, 1.0]) @ transform
    scale = 1.0 / np.max(np.abs(new_poses[:, :3, 3]))
    new_poses[:, :3, 3] *= scale
    transform = np.diag([scale] * 3 + [1.0]) @ transform
    return new_poses, float(np.sqrt((transform[:3, :3] @ transform[:3, :3].T)[0, 0]))


def train_views(n: int):
    test = set(range(9, n, 10))
    return [i for i in range(n) if i not in test]


class Scene:
    """The scene as the reference reads it: train cameras, colours and depths."""

    def __init__(self, scene_dir: str, params: dict):
        names, poses = read_poses(os.path.join(scene_dir, "sparse", "0"))
        poses, self.scale = normalize_poses_pca(poses)
        idx = train_views(len(names))
        self.c2w = poses[idx].astype(np.float32)
        self.names = [names[i] for i in idx]
        self.k = scene_lib.intrinsics(params)
        self.pixtocam = np.linalg.inv(self.k).astype(np.float32)
        self.dir = scene_dir
        self._rgb, self._depth = {}, {}

    def rgb(self, cam: int):
        if cam not in self._rgb:
            code = scene_lib.decode_png(os.path.join(self.dir, "images", self.names[cam]))
            self._rgb[cam] = (code.astype(np.float32) / 255.0).astype(np.float32)
        return self._rgb[cam]

    def depth(self, cam: int):
        if cam not in self._depth:
            raw = scene_lib.decode_png(os.path.join(self.dir, "depths_gt", self.names[cam]))
            d = raw.astype(np.float32)
            invalid = d < 2.0
            d = d / 256.0 * self.scale
            d[invalid] = -1.0
            self._depth[cam] = d
        return self._depth[cam]

    def cast(self, cam: np.ndarray, px: np.ndarray, py: np.ndarray):
        """Pinhole rays of pixel centres: origins, directions, viewdirs, radii."""
        def dirs(x, y):
            pix = np.stack([x + 0.5, y + 0.5, np.ones_like(x)], -1).astype(np.float32)
            v = pix @ self.pixtocam.T
            v = v * np.array([1.0, -1.0, -1.0], np.float32)
            return np.einsum("nij,nj->ni", self.c2w[cam, :3, :3], v)
        d = dirs(px, py)
        dx = np.linalg.norm(dirs(px + 1, py) - d, axis=-1)
        dy = np.linalg.norm(dirs(px, py + 1) - d, axis=-1)
        radii = 0.5 * (dx + dy) * 2.0 / np.sqrt(12.0)
        return (self.c2w[cam, :3, 3], d, d / np.linalg.norm(d, axis=-1, keepdims=True),
                radii[:, None])


def batch_errors(scene: Scene, batch: dict) -> int:
    """How many of the batch's rays are not the scene's rays, colours and depths."""
    cam = batch["cam_idx"].numpy().reshape(-1).astype(np.int64)
    o = batch["origins"].numpy()
    d = batch["directions"].numpy().astype(np.float64)
    n = len(cam)
    if cam.min() < 0 or cam.max() >= len(scene.names):
        return n
    rot = scene.c2w[cam, :3, :3].astype(np.float64)
    v = np.einsum("nji,nj->ni", rot, d) * np.array([1.0, -1.0, -1.0])
    uv = (v / v[:, 2:3]) @ scene.k.T
    px, py = np.round(uv[:, 0] - 0.5), np.round(uv[:, 1] - 0.5)
    h, w = scene.rgb(0).shape[:2]
    bad = (np.abs(uv[:, 0] - 0.5 - px) > 1e-2) | (np.abs(uv[:, 1] - 0.5 - py) > 1e-2)
    bad |= (px < 0) | (px >= w) | (py < 0) | (py >= h) | (v[:, 2] <= 0)
    px = np.clip(px, 0, w - 1).astype(np.int64)
    py = np.clip(py, 0, h - 1).astype(np.int64)
    rgb = np.zeros((n,) + scene.rgb(0).shape[2:], np.float32)
    depth = np.zeros(n, np.float32)
    for c in np.unique(cam):
        at = cam == c
        rgb[at] = scene.rgb(c)[py[at], px[at]]
        depth[at] = scene.depth(c)[py[at], px[at]]
    bad |= np.any(rgb != batch["rgb"].numpy(), axis=-1)
    bad |= depth != batch["depth_gt"].numpy()
    bad |= depth != batch["depth_sup"].numpy()
    o_ref, d_ref, vd_ref, r_ref = scene.cast(cam, px.astype(np.float32), py.astype(np.float32))

    def off(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b, axis=-1) > RAY_RTOL * np.maximum(np.linalg.norm(b, axis=-1), 1.0)

    bad |= off(o, o_ref) | off(d, d_ref) | off(batch["viewdirs"].numpy(), vd_ref)
    r = batch["radii"].numpy().astype(np.float64)
    bad |= np.abs(r - r_ref).reshape(-1) > RADIUS_RTOL * np.abs(r_ref).reshape(-1)
    return int(bad.sum())
