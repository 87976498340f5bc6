"""Self-contained COLMAP sparse-model IO (binary and text), numpy only.

A copy of the reference package's `data/colmap.py`: a compact reader and
writer for the documented COLMAP sparse format (cameras/images/points3D in
.bin or .txt), plus `load_scene()`, which applies the NeRF-specific
postprocessing the loaders need: world-to-camera -> camera-to-world
inversion and the OpenCV->OpenGL axis flip. The binary writers produce the
same bytes as the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

# model_id -> (name, num_params). Params are ordered per COLMAP's spec.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),  # f, cx, cy, k1
    3: ("RADIAL", 5),  # f, cx, cy, k1, k2
    4: ("OPENCV", 8),  # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),  # fx, fy, cx, cy, k1, k2, k3, k4
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific, see CAMERA_MODELS

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[0] if self.model.startswith(("SIMPLE", "RADIAL", "FOV")) else self.params[1]

    @property
    def cx(self):
        return self.params[1] if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE") else self.params[2]

    @property
    def cy(self):
        return self.params[2] if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE") else self.params[3]


@dataclasses.dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # [4] w,x,y,z
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [n, 2]
    point3d_ids: np.ndarray  # [n]

    def rotation(self) -> np.ndarray:
        return quaternion_to_rotation(self.qvec)

    def world_to_cam(self) -> np.ndarray:
        """[4, 4] world-to-camera matrix."""
        m = np.eye(4)
        m[:3, :3] = self.rotation()
        m[:3, 3] = self.tvec
        return m


@dataclasses.dataclass
class Point3D:
    point3d_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) quaternion (not necessarily unit)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion of a rotation matrix (Shepperd's method)."""
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


# --------------------------------------------------------------------------
# Binary format.
# --------------------------------------------------------------------------


def _read(fmt: str, f) -> tuple:
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, width, height = _read("<iiQQ", f)
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{n_params}d", f))
            out[cam_id] = Camera(cam_id, name, width, height, params)
    return out


def read_images_bin(path: str) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            vals = _read("<i7d", f)
            image_id, qw, qx, qy, qz, tx, ty, tz = vals
            (camera_id,) = _read("<i", f)
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = _read("<Q", f)
            rec = np.frombuffer(
                f.read(24 * n_pts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
            )
            xys = np.stack([rec["x"], rec["y"]], -1) if n_pts else np.zeros((0, 2))
            ids = rec["id"].copy() if n_pts else np.zeros(0, np.int64)
            out[image_id] = Image(
                image_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                camera_id,
                name.decode("utf-8"),
                xys,
                ids,
            )
    return out


def read_points3d_bin(path: str) -> Dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read("<QdddBBBd", f)
            (track_len,) = _read("<Q", f)
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(-1, 2)
            out[pid] = Point3D(
                pid,
                np.array([x, y, z]),
                np.array([r, g, b], dtype=np.uint8),
                err,
                track[:, 0].copy(),
                track[:, 1].copy(),
            )
    return out


def write_cameras_bin(cams: Mapping[int, Camera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(
                struct.pack(
                    "<iiQQ", cam.camera_id, _MODEL_IDS[cam.model], cam.width, cam.height
                )
            )
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_bin(images: Mapping[int, Image], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i7d", im.image_id, *im.qvec, *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3d_ids)))
            for xy, pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3d_bin(points: Mapping[int, Point3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Qddd", p.point3d_id, *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


# --------------------------------------------------------------------------
# Text format.
# --------------------------------------------------------------------------


def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    out = {}
    for line in _data_lines(path):
        toks = line.split()
        cam_id, model = int(toks[0]), toks[1]
        out[cam_id] = Camera(
            cam_id, model, int(toks[2]), int(toks[3]), np.array([float(t) for t in toks[4:]])
        )
    return out


def read_images_txt(path: str) -> Dict[int, Image]:
    out = {}
    lines = list(_data_lines(path))
    for meta, pts in zip(lines[0::2], lines[1::2]):
        toks = meta.split()
        image_id = int(toks[0])
        qvec = np.array([float(t) for t in toks[1:5]])
        tvec = np.array([float(t) for t in toks[5:8]])
        camera_id, name = int(toks[8]), toks[9]
        p = pts.split()
        xys = np.array([float(v) for v in p], dtype=np.float64).reshape(-1, 3)[:, :2] if p else np.zeros((0, 2))
        ids = np.array([int(v) for v in p[2::3]], dtype=np.int64) if p else np.zeros(0, np.int64)
        out[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return out


def read_points3d_txt(path: str) -> Dict[int, Point3D]:
    out = {}
    for line in _data_lines(path):
        toks = line.split()
        pid = int(toks[0])
        xyz = np.array([float(t) for t in toks[1:4]])
        rgb = np.array([int(t) for t in toks[4:7]], dtype=np.uint8)
        err = float(toks[7])
        track = np.array([int(t) for t in toks[8:]], dtype=np.int32).reshape(-1, 2)
        out[pid] = Point3D(pid, xyz, rgb, err, track[:, 0], track[:, 1])
    return out


def write_cameras_txt(cams: Mapping[int, Camera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(
                f"{cam.camera_id} {cam.model} {cam.width} {cam.height} "
                f"{params}\n"
            )


def write_images_txt(images: Mapping[int, Image], path: str):
    with open(path, "w") as f:
        f.write(
            "# Image list, two lines per image:\n"
            "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
            "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
        )
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{float(x)!r} {float(y)!r} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3d_ids)
            )
            f.write(pts + "\n")


def write_points3d_txt(points: Mapping[int, Point3D], path: str):
    with open(path, "w") as f:
        f.write(
            "# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}"
                for i, j in zip(p.image_ids, p.point2d_idxs)
            )
            f.write(f"{p.point3d_id} {xyz} {rgb} {float(p.error)!r} {track}\n")


def write_model_txt(cams, images, points, sparse_dir: str):
    """Write a full txt model (the layout `point_triangulator` ingests)."""
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_txt(cams, os.path.join(sparse_dir, "cameras.txt"))
    write_images_txt(images, os.path.join(sparse_dir, "images.txt"))
    write_points3d_txt(points, os.path.join(sparse_dir, "points3D.txt"))


def read_model(sparse_dir: str, load_points: bool = False):
    """Read a COLMAP sparse model dir, auto-detecting .bin vs .txt.

    Returns (cameras, images, points3D-or-None).
    """
    def pick(stem, bin_fn, txt_fn):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        if os.path.exists(b):
            return bin_fn(b)
        if os.path.exists(t):
            return txt_fn(t)
        raise FileNotFoundError(f"no {stem}.bin/.txt under {sparse_dir}")

    cams = pick("cameras", read_cameras_bin, read_cameras_txt)
    images = pick("images", read_images_bin, read_images_txt)
    points = pick("points3D", read_points3d_bin, read_points3d_txt) if load_points else None
    return cams, images, points


# --------------------------------------------------------------------------
# NeRF-facing postprocessing.
# --------------------------------------------------------------------------

_OPENCV_TO_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])


def load_scene(
    sparse_dir: str, load_points: bool = False
) -> Tuple[list, np.ndarray, np.ndarray, Optional[dict], str, Optional[np.ndarray]]:
    """Load a sparse model and convert to NeRF conventions.

    Returns:
      names: image basenames, sorted by COLMAP image id order.
      poses: [N, 4, 4] camera-to-world matrices in OpenGL axes
        (right/up/back), i.e. the COLMAP world-to-camera inverted and
        column-flipped.
      pixtocam: [3, 3] shared inverse intrinsics.
      distortion: dict of k1/k2/k3/k4/p1/p2 or None for pinhole models.
      camtype: 'perspective' | 'fisheye'.
      points: [P, 3] world points or None.
    """
    cams, images, points = read_model(sparse_dir, load_points=load_points)
    cam = next(iter(cams.values()))

    intrinsics = np.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]]
    )
    pixtocam = np.linalg.inv(intrinsics)

    names, poses = [], []
    for key in images:
        im = images[key]
        names.append(im.name)
        poses.append(np.linalg.inv(im.world_to_cam()) @ _OPENCV_TO_OPENGL)
    poses = np.stack(poses, axis=0)

    model, p = cam.model, cam.params
    distortion, camtype = None, "perspective"
    if model == "SIMPLE_RADIAL":
        distortion = {"k1": p[3], "k2": 0.0, "k3": 0.0, "p1": 0.0, "p2": 0.0}
    elif model == "RADIAL":
        distortion = {"k1": p[3], "k2": p[4], "k3": 0.0, "p1": 0.0, "p2": 0.0}
    elif model == "OPENCV":
        distortion = {"k1": p[4], "k2": p[5], "k3": 0.0, "p1": p[6], "p2": p[7]}
    elif model == "OPENCV_FISHEYE":
        distortion = {"k1": p[4], "k2": p[5], "k3": p[6], "k4": p[7]}
        camtype = "fisheye"

    pts = None
    if points is not None:
        pts = np.stack([q.xyz for q in points.values()]) if points else np.zeros((0, 3))
    return names, poses, pixtocam, distortion, camtype, pts
