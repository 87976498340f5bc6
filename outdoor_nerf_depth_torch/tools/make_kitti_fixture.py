"""Write a KITTI-layout fixture scene, so configs/kitti_*.json train on it as they are.

    python -m outdoor_nerf_depth_torch.tools.make_kitti_fixture <out_dir> [n_images=30]

Renders the analytic sphere+ground scene (`data/datasets.py:
trace_sphere_scene`) from a KITTI-like forward driving camera path (metric
units, 1/4 of a KITTI image) and writes both data layouts the KITTI configs
read:

  <out>/dtu_format/          the mip/NGP "DTU_format" driving layout
    sparse/0/{cameras,images,points3D}.bin   COLMAP model (OpenCV w2c)
    images/####.png                          uint8 RGB
    depths_gt/####.png                       uint16 metres*256 (0: no return)
    depths_{stereo_crop,mono_crop,mff_crop}/ noisy, sparsified priors
  <out>/nerfpp/              the NeRF++ per-image txt layout
    {train,test}/{intrinsics,pose}/*.txt (OpenCV c2w), rgb/, depth/,
    depth_stereo_crop/, min_depth/; a top-level `scale` file

The scene, the seeds (7 for the scene, 11 for the priors and points) and
the order of the draws are the reference tool's, so both write the same
arrays: the same pixels, depth codes and priors, and byte-identical COLMAP
files. PNGs go through the port's own codec (filter 0 on every row). Then:

    python -m outdoor_nerf_depth_torch --config configs/kitti_ngp.json \\
        scene_dir=<out>/dtu_format max_steps=...

`rewrite_camera` turns the written scene's pinhole COLMAP camera into one
with lens distortion or a fisheye lens (the images stay the pinhole
renders), so the camera models' ray casts can be driven on the fixture.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import colmap
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.data.datasets import split_indices, trace_sphere_scene


def make_scene():
    """Metric driving scene: ground plane + sphere 'objects' along a road."""
    rng = np.random.default_rng(7)
    n_obj = 10
    xs = np.linspace(4.0, 34.0, n_obj)
    ys = rng.uniform(2.5, 7.0, n_obj) * rng.choice([-1.0, 1.0], n_obj)
    radii = rng.uniform(0.8, 2.5, n_obj)
    centers = np.stack([xs, ys, radii], -1).astype(np.float32)  # resting on the ground
    colors = rng.uniform(0.2, 0.95, (n_obj, 3)).astype(np.float32)
    light = np.array([0.3, -0.25, 0.92], np.float32)
    light /= np.linalg.norm(light)
    return dict(
        centers=centers, radii=radii.astype(np.float32), colors=colors,
        light=light, ground_z=0.0, ground_r=80.0, ground_center=(15.0, 0.0),
    )


def camera_path(n_images: int):
    """OpenGL camera-to-world [N, 3, 4] of a car driving along +x."""
    poses = []
    for i in range(n_images):
        pos = np.array([i * 0.7, 0.15 * np.sin(i * 0.4), 1.6], np.float32)
        look = np.array([1.0, 0.1 * np.cos(i * 0.4), -0.05], np.float32)
        poses.append(cameras_lib.view_matrix(look, np.array([0.0, 0, 1.0]), pos))
    return np.stack(poses).astype(np.float32)


def save_depth_png(depth_m, path):
    raw = np.clip(np.where(depth_m > 0, depth_m, 0.0) * 256.0, 0, 65535)
    png.write_png(path, raw.astype(np.uint16))


def save_rgb_png(rgb, path):
    png.write_png(path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def main(out_dir: str, n_images: int = 30, height: int = 94, width: int = 310):
    scene = make_scene()
    c2ws = camera_path(n_images)
    focal = width * 1.2
    k = np.array(
        [[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1.0]],
        np.float32,
    )
    pixtocam = np.linalg.inv(k)

    rgbs, depths = [], []
    for c2w in c2ws:
        rgb, depth = trace_sphere_scene(c2w, pixtocam, height, width, near=0.5, **scene)
        rgbs.append(rgb)
        depths.append(depth)

    rng = np.random.default_rng(11)

    def prior(depth, noise, keep):
        """Noisy sparsified prior from gt (stands in for stereo/mono/mff)."""
        d = np.where(depth > 0, depth + rng.normal(0, noise, depth.shape), 0)
        mask = rng.uniform(size=depth.shape) < keep
        return np.where(mask, np.maximum(d, 0.0), 0.0)

    # ---- DTU_format (driving) layout.
    dtu = os.path.join(out_dir, "dtu_format")
    for sub in ("sparse/0", "images", "depths_gt", "depths_stereo_crop",
                "depths_mono_crop", "depths_mff_crop"):
        os.makedirs(os.path.join(dtu, sub), exist_ok=True)

    flip = np.diag([1.0, -1.0, -1.0])  # OpenGL c2w -> OpenCV c2w
    cams = {
        1: colmap.Camera(
            camera_id=1, model="PINHOLE", width=width, height=height,
            params=np.array([focal, focal, width / 2.0, height / 2.0]),
        )
    }
    images, points = {}, {}
    empty = np.zeros((0,), np.int64)
    for i, c2w in enumerate(c2ws):
        name = f"{i:04d}.png"
        c2w_cv = np.eye(4)
        c2w_cv[:3, :3] = c2w[:3, :3] @ flip
        c2w_cv[:3, 3] = c2w[:3, 3]
        w2c = np.linalg.inv(c2w_cv)
        images[i + 1] = colmap.Image(
            image_id=i + 1,
            qvec=colmap.rotation_to_quaternion(w2c[:3, :3]),
            tvec=w2c[:3, 3],
            camera_id=1,
            name=name,
            xys=np.zeros((0, 2)),
            point3d_ids=empty,
        )
        save_rgb_png(rgbs[i], os.path.join(dtu, "images", name))
        save_depth_png(depths[i], os.path.join(dtu, "depths_gt", name))
        save_depth_png(prior(depths[i], 0.15, 0.5),
                       os.path.join(dtu, "depths_stereo_crop", name))
        save_depth_png(prior(depths[i], 0.6, 0.4),
                       os.path.join(dtu, "depths_mono_crop", name))
        save_depth_png(prior(depths[i], 0.3, 0.7),
                       os.path.join(dtu, "depths_mff_crop", name))

    # Sparse surface points (backprojected depth samples) for pose tooling.
    pid = 1
    for i in range(0, n_images, 5):
        d = depths[i]
        ys, xs = np.where(d > 0)
        sel = rng.choice(len(ys), size=min(200, len(ys)), replace=False)
        pix = np.stack([xs[sel] + 0.5, ys[sel] + 0.5, np.ones(len(sel))], 0)
        cam_dirs = np.linalg.inv(k) @ pix  # OpenCV camera coordinates at z=1
        c2w = c2ws[i]
        dirs_cv = cam_dirs / cam_dirs[2]
        for j in range(len(sel)):
            p_cam = dirs_cv[:, j] * d[ys[sel][j], xs[sel][j]]
            p_world = c2w[:3, :3] @ (flip @ p_cam) + c2w[:3, 3]
            points[pid] = colmap.Point3D(
                point3d_id=pid, xyz=p_world,
                rgb=(rgbs[i][ys[sel][j], xs[sel][j]] * 255).astype(np.uint8),
                error=0.1, image_ids=np.array([i + 1]),
                point2d_idxs=np.array([0]),
            )
            pid += 1

    sparse = os.path.join(dtu, "sparse/0")
    colmap.write_cameras_bin(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_bin(images, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_bin(points, os.path.join(sparse, "points3D.bin"))

    # ---- NeRF++ layout (unit-sphere-normalized poses + scale file).
    nerfpp = os.path.join(out_dir, "nerfpp")
    centers_w = c2ws[:, :3, 3]
    center = centers_w.mean(0)
    radius = float(np.max(np.linalg.norm(centers_w - center, axis=-1))) * 1.1
    scale = 1.0 / radius  # metres -> normalized units
    k4 = np.eye(4)
    k4[:3, :3] = k
    for split in ("train", "test"):
        for sub in ("intrinsics", "pose", "rgb", "depth", "depth_stereo_crop",
                    "min_depth"):
            os.makedirs(os.path.join(nerfpp, split, sub), exist_ok=True)
        for i in split_indices(n_images, split):
            stem = f"{i:04d}"
            c2w_cv = np.eye(4)
            c2w_cv[:3, :3] = c2ws[i][:3, :3] @ flip
            c2w_cv[:3, 3] = (c2ws[i][:3, 3] - center) * scale
            np.savetxt(os.path.join(nerfpp, split, "intrinsics", stem + ".txt"),
                       k4.reshape(1, 16))
            np.savetxt(os.path.join(nerfpp, split, "pose", stem + ".txt"),
                       c2w_cv.reshape(1, 16))
            save_rgb_png(rgbs[i], os.path.join(nerfpp, split, "rgb", stem + ".png"))
            save_depth_png(depths[i], os.path.join(nerfpp, split, "depth", stem + ".png"))
            save_depth_png(prior(depths[i], 0.15, 0.5),
                           os.path.join(nerfpp, split, "depth_stereo_crop", stem + ".png"))
            png.write_png(os.path.join(nerfpp, split, "min_depth", stem + ".png"),
                          np.zeros((height, width), np.uint8))
    with open(os.path.join(nerfpp, "scale"), "w") as f:
        f.write(f"{scale}\n")

    print(f"fixture written: {dtu} and {nerfpp} ({n_images} views, "
          f"{height}x{width}, scale={scale:.6f})")


# The coefficients `rewrite_camera` gives each lens model, in COLMAP's order
# after the focal length(s) and principal point.
LENS_COEFFS = {
    "SIMPLE_RADIAL": (-0.08,),  # k1
    "RADIAL": (-0.08, 0.02),  # k1, k2
    "OPENCV": (-0.08, 0.02, 1e-3, -5e-4),  # k1, k2, p1, p2
    "OPENCV_FISHEYE": (0.03, -0.01, 2e-3, -3e-4),  # k1, k2, k3, k4
}


def rewrite_camera(dtu_dir: str, model: str):
    """Rewrite the shared camera of `dtu_dir`/sparse/0/cameras.bin as `model`
    with its LENS_COEFFS, keeping its focal length and principal point."""
    path = os.path.join(dtu_dir, "sparse/0/cameras.bin")
    cams = colmap.read_cameras_bin(path)
    (cam_id, cam), = cams.items()
    focal = (cam.fx,) if model in ("SIMPLE_RADIAL", "RADIAL") else (cam.fx, cam.fy)
    params = np.array(focal + (cam.cx, cam.cy) + LENS_COEFFS[model], np.float64)
    colmap.write_cameras_bin({cam_id: colmap.Camera(cam_id, model, cam.width, cam.height, params)},
                             path)


if __name__ == "__main__":
    if not 2 <= len(sys.argv) <= 3:
        raise SystemExit(__doc__.split("\n\n")[1])
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 30)
