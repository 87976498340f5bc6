"""Scene preprocessing: COLMAP driving, layout conversion, normalization.

Port of the reference package's `data/preprocess.py`: invoking the COLMAP
binary for SfM (`run_colmap`) or for triangulation against known poses
(`run_colmap_posed`, over a database from `build_posed_database`); both
raise FileNotFoundError when no `colmap` is on PATH. A sparse model converts
into a JSON hand-off (`extract_sfm_json`), the NeRF++ per-image txt layout
with the unit-sphere camera normalization NeRF++'s inverted-sphere
parametrization needs (`export_nerfpp_layout`), and camera frusta as JSON
(`export_camera_frusta_json`). The model IO is the port's `data/colmap.py`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from outdoor_nerf_depth_torch.data import colmap, colmap_db


def run_colmap(
    image_dir: str,
    workspace: str,
    camera_model: str = "SIMPLE_RADIAL",
    use_gpu: bool = False,
    matcher: str = "exhaustive",
    log_fn=print,
) -> str:
    """Run feature extraction + matching + mapping via the colmap CLI.

    Returns the sparse model directory (`workspace/sparse/0`). Raises
    FileNotFoundError when the binary is absent.
    """
    if shutil.which("colmap") is None:
        raise FileNotFoundError(
            "colmap binary not found on PATH; install COLMAP or provide a "
            "precomputed sparse model"
        )
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    gpu = "1" if use_gpu else "0"

    def run(*args):
        log_fn("$ colmap " + " ".join(args))
        subprocess.run(["colmap", *args], check=True)

    run(
        "feature_extractor",
        "--database_path", db,
        "--image_path", image_dir,
        "--ImageReader.camera_model", camera_model,
        "--ImageReader.single_camera", "1",
        "--SiftExtraction.use_gpu", gpu,
    )
    run(
        f"{matcher}_matcher",
        "--database_path", db,
        "--SiftMatching.use_gpu", gpu,
    )
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)
    run(
        "mapper",
        "--database_path", db,
        "--image_path", image_dir,
        "--output_path", sparse,
    )
    return os.path.join(sparse, "0")


def build_posed_database(
    db_path: str,
    names,
    K: np.ndarray,
    width: int,
    height: int,
    poses_c2w: Optional[np.ndarray] = None,
    camera_model: str = "PINHOLE",
):
    """Create a COLMAP database pre-registered with known cameras/images.

    The first half of the reference's `run_colmap_posed.py`: one shared
    camera, every image inserted (with pose priors when `poses_c2w` given,
    OpenCV c2w [N,3,4] or [N,4,4]) so feature extraction keeps stable ids
    and `point_triangulator` can run against fixed poses. Returns
    {name: image_id}.
    """
    if camera_model == "PINHOLE":
        params = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    elif camera_model == "SIMPLE_PINHOLE":
        params = np.array([K[0, 0], K[0, 2], K[1, 2]])
    else:
        raise ValueError(f"unsupported posed camera model {camera_model!r}")

    ids = {}
    with colmap_db.ColmapDatabase(db_path) as db:
        cam_id = db.add_camera(camera_model, width, height, params)
        for i, name in enumerate(names):
            qvec = tvec = None
            if poses_c2w is not None:
                w2c = np.linalg.inv(
                    np.vstack([poses_c2w[i][:3, :4], [[0, 0, 0, 1]]])
                )
                qvec = colmap.rotation_to_quaternion(w2c[:3, :3])
                tvec = w2c[:3, 3]
            ids[name] = db.add_image(name, cam_id, qvec=qvec, tvec=tvec)
    return ids


def run_colmap_posed(
    image_dir: str,
    workspace: str,
    poses_c2w: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    use_gpu: bool = False,
    log_fn=print,
) -> str:
    """Triangulate a sparse model against KNOWN camera poses.

    The reference's `colmap_runner/run_colmap_posed.py` pipeline: build a
    database with fixed cameras + pose priors, extract/match features, write
    a points-free txt model carrying the known poses, and run
    `colmap point_triangulator` (which keeps poses fixed). Returns the
    triangulated sparse dir.
    """
    if shutil.which("colmap") is None:
        raise FileNotFoundError("colmap binary not found on PATH")
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    names = sorted(os.listdir(image_dir))
    ids = build_posed_database(db, names, K, width, height, poses_c2w)

    gpu = "1" if use_gpu else "0"

    def run(*args):
        log_fn("$ colmap " + " ".join(args))
        subprocess.run(["colmap", *args], check=True)

    run(
        "feature_extractor",
        "--database_path", db,
        "--image_path", image_dir,
        "--SiftExtraction.use_gpu", gpu,
    )
    run("exhaustive_matcher", "--database_path", db,
        "--SiftMatching.use_gpu", gpu)

    # Known-pose model with zero 3D points for the triangulator to fill.
    prior_dir = os.path.join(workspace, "sparse_prior")
    cams = {
        1: colmap.Camera(
            1, "PINHOLE", width, height,
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        )
    }
    images = {}
    for i, name in enumerate(names):
        w2c = np.linalg.inv(np.vstack([poses_c2w[i][:3, :4], [[0, 0, 0, 1]]]))
        images[ids[name]] = colmap.Image(
            ids[name],
            colmap.rotation_to_quaternion(w2c[:3, :3]),
            w2c[:3, 3],
            1,
            name,
            np.zeros((0, 2)),
            np.zeros(0, np.int64),
        )
    colmap.write_model_txt(cams, images, {}, prior_dir)

    out_dir = os.path.join(workspace, "sparse", "0")
    os.makedirs(out_dir, exist_ok=True)
    run(
        "point_triangulator",
        "--database_path", db,
        "--image_path", image_dir,
        "--input_path", prior_dir,
        "--output_path", out_dir,
    )
    return out_dir


def extract_sfm_json(sparse_dir: str, out_path: str) -> int:
    """Dump the sparse reconstruction (poses, intrinsics, tracks) to JSON.

    Equivalent of `colmap_runner/extract_sfm.py`: per-image {K, W2C,
    image size, observed 3D point ids} plus the point cloud — the portable
    hand-off format for downstream tools. Returns the number of images.
    """
    cams, images, points = colmap.read_model(sparse_dir, load_points=True)
    out = {"images": {}, "points": []}
    for im in sorted(images.values(), key=lambda i: i.name):
        cam = cams[im.camera_id]
        K = [[float(cam.fx), 0.0, float(cam.cx)],
             [0.0, float(cam.fy), float(cam.cy)], [0.0, 0.0, 1.0]]
        out["images"][im.name] = {
            "K": K,
            "W2C": im.world_to_cam().tolist(),
            "width": int(cam.width),
            "height": int(cam.height),
            "point3d_ids": [int(p) for p in im.point3d_ids if p >= 0],
        }
    for p in points.values():
        out["points"].append(
            {"id": int(p.point3d_id), "xyz": p.xyz.tolist(),
             "rgb": p.rgb.tolist(), "error": float(p.error)}
        )
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out["images"])


def camera_centers_from_model(images) -> np.ndarray:
    """World positions of all registered cameras, [N, 3]."""
    return np.stack(
        [-im.rotation().T @ im.tvec for im in images.values()], axis=0
    )


def unit_sphere_transform(
    centers: np.ndarray, margin: float = 1.1
) -> Tuple[np.ndarray, float]:
    """(translate, scale) putting all camera centers inside the unit sphere.

    Matches `colmap_runner/normalize_cam_dict.py` semantics: recenter on the
    centroid, scale so the farthest camera sits at 1/margin. Returns
    (center [3], scale) with new_pos = (pos - center) / scale.
    """
    center = centers.mean(axis=0)
    radius = np.linalg.norm(centers - center, axis=-1).max()
    return center, float(radius * margin)


def export_nerfpp_layout(
    sparse_dir: str,
    image_dir: str,
    out_dir: str,
    split: str = "train",
    normalize: bool = True,
    depth_scale: Optional[float] = None,
    log_fn=print,
):
    """Convert a COLMAP model into the NeRF++ per-image txt layout.

    Writes `{out}/{split}/{intrinsics,pose}/*.txt` (4x4 flattened, OpenCV
    c2w convention, as `data_loader_split.py` expects), symlinks/copies rgb,
    and a top-level `scale` file when depths will be attached (the metric
    -> normalized conversion factor = 1/scene_radius).
    """
    cams, images, _ = colmap.read_model(sparse_dir)
    cam = next(iter(cams.values()))
    K = np.eye(4)
    K[:3, :3] = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])

    centers = camera_centers_from_model(images)
    if normalize:
        center, scale = unit_sphere_transform(centers)
    else:
        center, scale = np.zeros(3), 1.0

    for sub in ("intrinsics", "pose", "rgb"):
        os.makedirs(os.path.join(out_dir, split, sub), exist_ok=True)

    ordered = sorted(images.values(), key=lambda im: im.name)
    for im in ordered:
        stem = os.path.splitext(im.name)[0]
        c2w = np.linalg.inv(im.world_to_cam())  # OpenCV convention
        c2w[:3, 3] = (c2w[:3, 3] - center) / scale
        np.savetxt(
            os.path.join(out_dir, split, "intrinsics", stem + ".txt"),
            K.reshape(1, 16),
        )
        np.savetxt(
            os.path.join(out_dir, split, "pose", stem + ".txt"),
            c2w.reshape(1, 16),
        )
        src = os.path.join(image_dir, im.name)
        dst = os.path.join(out_dir, split, "rgb", im.name)
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.copy(src, dst)

    # The scene `scale` file: depths in metres multiply by 1/scale to land
    # in normalized units (reference `data_loader_split.py:87`).
    with open(os.path.join(out_dir, "scale"), "w") as f:
        f.write(f"{(depth_scale if depth_scale is not None else 1.0 / scale):.10f}\n")
    log_fn(
        f"exported {len(ordered)} cameras to {out_dir}/{split} "
        f"(center {np.round(center, 3).tolist()}, radius scale {scale:.3f})"
    )
    return center, scale


def export_camera_frusta_json(sparse_dir: str, out_path: str, frustum_depth=0.1):
    """Camera frustum line segments as JSON for external viewers.

    The upstream code ships an open3d visualizer
    (`camera_visualizer/visualize_cameras.py`); this exports the same
    geometry as portable JSON, which the reference package's
    `utils/vis.plot_camera_frusta` draws.
    """
    cams, images, _ = colmap.read_model(sparse_dir)
    cam = next(iter(cams.values()))
    frusta = []
    for im in sorted(images.values(), key=lambda i: i.name):
        c2w = np.linalg.inv(im.world_to_cam())
        # Frustum corners at unit depth in camera frame (OpenCV axes).
        z = frustum_depth
        corners_cam = np.array(
            [
                [0, 0, 0],
                [-cam.cx / cam.fx * z, -cam.cy / cam.fy * z, z],
                [cam.cx / cam.fx * z, -cam.cy / cam.fy * z, z],
                [cam.cx / cam.fx * z, cam.cy / cam.fy * z, z],
                [-cam.cx / cam.fx * z, cam.cy / cam.fy * z, z],
            ]
        )
        world = (c2w[:3, :3] @ corners_cam.T).T + c2w[:3, 3]
        frusta.append({"name": im.name, "corners": world.tolist()})
    with open(out_path, "w") as f:
        json.dump({"frusta": frusta}, f)
    return len(frusta)
