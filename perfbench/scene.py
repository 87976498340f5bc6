"""The analytic driving scene every cell trains on, written in the DTU_format layout.

A copy of the port's fixture scene (ground disk and spheres along a road, in
metres) and of its closed-form ray caster, kept here so a change to the
program cannot move what the benchmark drives. The scene file
(`perfbench/scenes/<name>.json`) sets the frame size, the number of views
and the camera; the writer renders every view and writes

  <dir>/sparse/0/{cameras,images,points3D}.bin   COLMAP model (OpenCV w2c)
  <dir>/images/####.png                          uint8 RGB
  <dir>/depths_gt/####.png                       uint16 metres*256 (0: no return)

which the port's `DrivingSceneDataset` reads back. The scene is fixed data,
like a recorded sequence: it depends on the scene file alone, never on a
run's seed, and is written once into a directory keyed by its parameters.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import zlib

import numpy as np

INVALID_DEPTH = -1.0
OPENCV_TO_OPENGL3 = np.diag([1.0, -1.0, -1.0])
SCENE_FORMAT = 1  # bump when the written layout changes


def make_objects(seed: int = 7, n_obj: int = 10):
    """Ground disk and spheres resting on it along a road (the port's fixture scene)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(4.0, 34.0, n_obj)
    ys = rng.uniform(2.5, 7.0, n_obj) * rng.choice([-1.0, 1.0], n_obj)
    radii = rng.uniform(0.8, 2.5, n_obj)
    centers = np.stack([xs, ys, radii], -1).astype(np.float32)
    colors = rng.uniform(0.2, 0.95, (n_obj, 3)).astype(np.float32)
    light = np.array([0.3, -0.25, 0.92], np.float32)
    light /= np.linalg.norm(light)
    return dict(centers=centers, radii=radii.astype(np.float32), colors=colors,
                light=light, ground_z=0.0, ground_r=80.0, ground_center=(15.0, 0.0))


def view_matrix(lookdir, up, position) -> np.ndarray:
    """OpenGL camera-to-world [3, 4] from forward, up and position."""
    norm = lambda v: v / np.linalg.norm(v)
    z = norm(lookdir)
    x = norm(np.cross(up, z))
    y = norm(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def camera_path(n_images: int, step_m: float) -> np.ndarray:
    """OpenGL camera-to-world [N, 3, 4] of a car driving along +x at `step_m` a frame."""
    poses = []
    for i in range(n_images):
        pos = np.array([i * step_m, 0.15 * np.sin(i * 0.4), 1.6], np.float32)
        look = np.array([1.0, 0.1 * np.cos(i * 0.4), -0.05], np.float32)
        poses.append(view_matrix(look, np.array([0.0, 0, 1.0]), pos))
    return np.stack(poses).astype(np.float32)


def intrinsics(params: dict) -> np.ndarray:
    f, cx, cy = params["focal"], params["cx"], params["cy"]
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]], np.float64)


def pixel_rays(pix_x, pix_y, pixtocam, c2w):
    """Origins and unit directions of pixel centres of a pinhole camera (OpenGL c2w)."""
    pix = np.stack([pix_x + 0.5, pix_y + 0.5, np.ones_like(pix_x)], axis=-1)
    cam_dirs = (pix @ pixtocam.T.astype(np.float32)) @ OPENCV_TO_OPENGL3.astype(np.float32)
    d = cam_dirs @ c2w[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return o.astype(np.float32), d.astype(np.float32)


def trace(c2w, pixtocam, height: int, width: int, near: float, centers, radii, colors,
          light, ground_z: float, ground_r: float, ground_center=(0.0, 0.0)):
    """Closed-form ray casting: rgb [H, W, 3] in [0, 1], depth [H, W] along the ray
    (INVALID_DEPTH where nothing is hit)."""
    px, py = np.meshgrid(np.arange(width, dtype=np.float32),
                         np.arange(height, dtype=np.float32), indexing="xy")
    o, d = pixel_rays(px, py, pixtocam, c2w)
    t_hit = np.full(px.shape, np.inf, np.float32)
    rgb = np.zeros(px.shape + (3,), np.float32)
    for c, r, col in zip(centers, radii, colors):
        oc = o - c
        b = np.sum(oc * d, -1)
        disc = b**2 - (np.sum(oc**2, -1) - r**2)
        valid = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid &= (t > near) & (t < t_hit)
        normal = (o + t[..., None] * d - c) / r
        shade = 0.35 + 0.65 * np.maximum(0.0, np.sum(normal * light, -1))
        rgb = np.where(valid[..., None], col * shade[..., None], rgb)
        t_hit = np.where(valid, t, t_hit)
    tz = (ground_z - o[..., 2]) / np.where(np.abs(d[..., 2]) < 1e-8, 1e-8, d[..., 2])
    hit_pt = o + tz[..., None] * d
    rel = hit_pt[..., :2] - np.asarray(ground_center, np.float32)
    on_disk = (tz > near) & (tz < t_hit) & (np.linalg.norm(rel, axis=-1) < ground_r)
    albedo = np.stack([0.45 + 0.35 * rel[..., 0] / ground_r,
                       0.5 + 0.35 * rel[..., 1] / ground_r,
                       np.full(tz.shape, 0.55, np.float32)], -1)
    rgb = np.where(on_disk[..., None], albedo * light[2], rgb)
    t_hit = np.where(on_disk, tz, t_hit)
    depth = np.where(np.isfinite(t_hit), t_hit, INVALID_DEPTH)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), depth.astype(np.float32)


def rgb_codes(rgb) -> np.ndarray:
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def depth_codes(depth_m) -> np.ndarray:
    return np.clip(np.where(depth_m > 0, depth_m, 0.0) * 256.0, 0, 65535).astype(np.uint16)


# ---------------------------------------------------------------- PNG codec


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of uint8 [H, W, 3] or uint16 [H, W], filter 0 on every row."""
    height, width = image.shape[:2]
    colour = 2 if image.ndim == 3 else 0
    depth = 8 * image.dtype.itemsize
    rows = np.ascontiguousarray(image, dtype=">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(height, -1).view(np.uint8)
    filtered = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1)) + _chunk(b"IEND", b""))


def decode_png(path: str) -> np.ndarray:
    """Read back a PNG written by `encode_png` (filter 0 rows only)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat += payload
        pos += 12 + length
    width, height, depth, colour = header[:4]
    channels = 3 if colour == 2 else 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, -1)
    if np.any(raw[:, 0] != 0):
        raise ValueError(f"{path}: a row filter other than 0")
    rows = raw[:, 1:]
    if depth == 16:
        return rows.copy().view(">u2").astype(np.uint16).reshape(height, width)
    return rows.reshape(height, width, channels).copy()


# ------------------------------------------------------------ COLMAP binary


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[0] = (R[k, j] - R[j, k]) / s
        q[i + 1] = 0.25 * s
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
    q = np.array(q)
    return q if q[0] >= 0 else -q


def write_colmap(sparse_dir: str, width: int, height: int, k: np.ndarray, c2ws, names):
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, width, height))  # model 1: PINHOLE
        f.write(struct.pack("<4d", k[0, 0], k[1, 1], k[0, 2], k[1, 2]))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, (c2w, name) in enumerate(zip(c2ws, names)):
            c2w_cv = np.eye(4)
            c2w_cv[:3, :3] = c2w[:3, :3] @ OPENCV_TO_OPENGL3
            c2w_cv[:3, 3] = c2w[:3, 3]
            w2c = np.linalg.inv(c2w_cv)
            f.write(struct.pack("<i7d", i + 1, *rotation_to_quaternion(w2c[:3, :3]), *w2c[:3, 3]))
            f.write(struct.pack("<i", 1) + name.encode() + b"\x00" + struct.pack("<Q", 0))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 0))


# ------------------------------------------------------------------- scene


def scene_key(params: dict) -> str:
    blob = json.dumps({"format": SCENE_FORMAT, **params}, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


def write_scene(out_dir: str, params: dict):
    """Render and write the scene into `out_dir` (made afresh)."""
    objects = make_objects(params["object_seed"], params["n_objects"])
    c2ws, k = camera_path(params["n_views"], params["step_m"]), intrinsics(params)
    pixtocam = np.linalg.inv(k)
    h, w = params["height"], params["width"]
    names = [f"{i:04d}.png" for i in range(params["n_views"])]
    os.makedirs(os.path.join(out_dir, "images"))
    os.makedirs(os.path.join(out_dir, "depths_gt"))
    for c2w, name in zip(c2ws, names):
        rgb, depth = trace(c2w, pixtocam, h, w, near=params["trace_near"], **objects)
        with open(os.path.join(out_dir, "images", name), "wb") as f:
            f.write(encode_png(rgb_codes(rgb)))
        with open(os.path.join(out_dir, "depths_gt", name), "wb") as f:
            f.write(encode_png(depth_codes(depth)))
    write_colmap(os.path.join(out_dir, "sparse", "0"), w, h, k, c2ws, names)


def ensure_scene(cache_root: str, params: dict) -> str:
    """The scene's directory under `cache_root`, written first if it is missing.

    Written into a sibling directory and renamed, so a run cut off while
    writing leaves no half scene behind."""
    final = os.path.join(cache_root, f"scene-{scene_key(params)}")
    if os.path.isdir(final):
        return final
    os.makedirs(cache_root, exist_ok=True)
    partial = final + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    write_scene(partial, params)
    os.replace(partial, final)
    return final
