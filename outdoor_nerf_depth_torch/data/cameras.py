"""Pinhole cameras, pixel->ray casting with mip-NeRF cone radii, pose normalization.

Port of the reference package's `data/cameras.py` for the mip-NeRF and NGP
train paths: camera setup in numpy on the host (`pinhole_pixtocam`,
`pixel_grid`, `view_matrix`), pose recentering and PCA normalization in
numpy (the source of the scene scale that multiplies every depth map), and
the cast of pixels to rays in torch, on whichever device the tensors live
(the train step casts on the GPU). `ray_origins_and_viewdirs_np` is the
reference's numpy cast, kept bit for bit for the scene tracer of fixtures.
The render paths (`generate_ellipse_path`, `generate_spiral_path`,
`generate_spline_path`, around `focus_point`), the NGP-style pose
normalization (`normalize_poses_min_norm`) and the two-view epipolar
helpers (`fundamental_matrix`, `epipolar_line`) are the reference's numpy;
`rays_to_ndc` maps rays to normalized device coordinates in torch.
The cast takes perspective and fisheye cameras, with or without the OpenCV
radial (k1..k4) and tangential (p1, p2) lens distortion, which it inverts
by Newton steps.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import rays as rays_lib

_OPENCV_TO_OPENGL3 = np.diag([1.0, -1.0, -1.0])


def intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    """[3,3] pinhole intrinsics in OpenCV pixel convention."""
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def pinhole_pixtocam(focal, width, height) -> np.ndarray:
    """Inverse intrinsics of an ideal centered pinhole."""
    return np.linalg.inv(intrinsics_matrix(focal, focal, 0.5 * width, 0.5 * height))


def pixel_grid(width: int, height: int):
    """Integer (x, y) coordinate grids, shape [height, width] each."""
    return np.meshgrid(np.arange(width), np.arange(height), indexing="xy")


def view_matrix(lookdir, up, position) -> np.ndarray:
    """Camera-to-world from forward/up/position (OpenGL convention)."""
    z = _normalize(lookdir)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def _normalize(v):
    return v / np.linalg.norm(v)


def ray_origins_and_viewdirs_np(pix_x, pix_y, pixtocams, camtoworlds):
    """Origins and unit directions of `pixels_to_rays`, in numpy.

    The same operations in the same order and dtypes as the reference's
    numpy cast (float32 pixels and cameras, the float64 axis flip, the
    neighbour rays cast alongside), so a fixture traced through it has the
    reference's pixels bit for bit. Undistorted perspective cameras only.
    """
    mk = lambda x, y: np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)
    trio = np.stack([mk(pix_x, pix_y), mk(pix_x + 1, pix_y), mk(pix_x, pix_y + 1)])
    mat_vec = lambda a, v: (a @ v[..., None])[..., 0]
    cam_dirs = mat_vec(pixtocams, trio) @ _OPENCV_TO_OPENGL3
    directions = mat_vec(camtoworlds[..., :3, :3], cam_dirs)[0]
    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    return origins, directions / np.linalg.norm(directions, axis=-1, keepdims=True)


def _undistort(xd, yd, dist, iters: int = 10):
    """Invert the OpenCV radial (k1..k4) / tangential (p1, p2) model by Newton
    steps; a step is taken only where the Jacobian's |det| > 1e-9."""
    k1 = dist.get("k1", 0.0)
    k2 = dist.get("k2", 0.0)
    k3 = dist.get("k3", 0.0)
    k4 = dist.get("k4", 0.0)
    p1 = dist.get("p1", 0.0)
    p2 = dist.get("p2", 0.0)
    x, y = xd, yd
    for _ in range(iters):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
        fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
        d_r = k1 + r * (2 * k2 + r * (3 * k3 + r * 4 * k4))
        fx_x = d + 2 * x * x * d_r + 2 * p1 * y + 6 * p2 * x
        fx_y = 2 * x * y * d_r + 2 * p1 * x + 2 * p2 * y
        fy_x = 2 * x * y * d_r + 2 * p2 * y + 2 * p1 * x
        fy_y = d + 2 * y * y * d_r + 2 * p2 * x + 6 * p1 * y
        det = fy_x * fx_y - fx_x * fy_y
        safe = torch.abs(det) > 1e-9
        x = x + torch.where(safe, (fx * fy_y - fy * fx_y) / det, 0.0)
        y = y + torch.where(safe, (fy * fx_x - fx * fy_x) / det, 0.0)
    return x, y


def pixels_to_rays(pix_x, pix_y, pixtocams, camtoworlds, distortion=None, camtype="perspective"):
    """Cast rays through pixel centers, with mip-NeRF cone radii.

    Vectorized over leading dims of pix_x/pix_y; pixtocams [.., 3, 3] and
    camtoworlds [.., 3, 4] broadcast against them. `distortion` is a dict of
    k1..k4, p1, p2 (missing keys are 0) or None; `camtype` "fisheye" takes
    the equidistant map theta = |xy| (capped at pi), any other value is a
    perspective camera. Returns
    (origins, directions, viewdirs, radii, imageplane).

    Like the reference, the fisheye map divides by theta unguarded: a pixel
    centre exactly on the principal point gives NaN rays.
    """
    mk = lambda x, y: torch.stack([x + 0.5, y + 0.5, torch.ones_like(x)], dim=-1)
    trio = torch.stack([mk(pix_x, pix_y), mk(pix_x + 1, pix_y), mk(pix_x, pix_y + 1)])
    mat_vec = lambda a, v: (a @ v[..., None])[..., 0]

    cam_dirs = mat_vec(pixtocams, trio)
    if distortion is not None:
        ux, uy = _undistort(cam_dirs[..., 0], cam_dirs[..., 1], distortion)
        cam_dirs = torch.stack([ux, uy, torch.ones_like(ux)], dim=-1)
    if camtype == "fisheye":
        theta = torch.clamp(torch.sqrt(torch.sum(torch.square(cam_dirs[..., :2]), dim=-1)),
                            max=math.pi)
        sinc = torch.sin(theta) / theta
        cam_dirs = torch.stack(
            [cam_dirs[..., 0] * sinc, cam_dirs[..., 1] * sinc, torch.cos(theta)], dim=-1)
    flip = torch.as_tensor(_OPENCV_TO_OPENGL3, dtype=cam_dirs.dtype, device=cam_dirs.device)
    cam_dirs = cam_dirs @ flip
    imageplane = cam_dirs[0, ..., :2]

    world_dirs = mat_vec(camtoworlds[..., :3, :3], cam_dirs)
    directions, dx, dy = world_dirs[0], world_dirs[1], world_dirs[2]
    origins = torch.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)

    dx_norm = torch.linalg.norm(dx - directions, dim=-1)
    dy_norm = torch.linalg.norm(dy - directions, dim=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * (2.0 / np.sqrt(12.0))
    return origins, directions, viewdirs, radii, imageplane


def cast_pixels(pixels: rays_lib.Pixels, cameras, camtype="perspective") -> rays_lib.Rays:
    """Pixels -> Rays given stacked per-camera (pixtocams, camtoworlds, dist).

    `cameras` is (pixtocams [3,3] or [N,3,3], camtoworlds [N,3,4],
    distortion-or-None) as tensors on the pixels' device.
    """
    pixtocams, camtoworlds, distortion = cameras
    cam_idx = pixels.cam_idx[..., 0].long()
    gather = lambda arr: arr if arr.ndim == 2 else arr[cam_idx]
    origins, directions, viewdirs, radii, imageplane = pixels_to_rays(
        pixels.pix_x, pixels.pix_y, gather(pixtocams), gather(camtoworlds),
        distortion=distortion, camtype=camtype,
    )
    return rays_lib.Rays(
        origins=origins,
        directions=directions,
        viewdirs=viewdirs,
        radii=radii,
        imageplane=imageplane,
        lossmult=pixels.lossmult,
        near=pixels.near,
        far=pixels.far,
        cam_idx=pixels.cam_idx,
        exposure_idx=pixels.exposure_idx,
        exposure_values=pixels.exposure_values,
    )


# --------------------------------------------------------------------------
# Pose normalization, in numpy on the host. The scale these produce folds
# into every depth map.
# --------------------------------------------------------------------------


def pad_pose(p: np.ndarray) -> np.ndarray:
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def average_pose(poses: np.ndarray, points: Optional[np.ndarray] = None):
    """The mean camera frame: center = point-cloud (or camera) centroid;
    z = normalized mean camera z; x = normalize(mean-y x z); y = z x x.
    Returns a [3, 4] camera-to-world frame."""
    use_pts = points is not None and len(points)
    center = points.mean(0) if use_pts else poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].mean(0)
    z = z / np.linalg.norm(z)
    y_ = poses[:, :3, 1].mean(0)
    x = np.cross(y_, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, center], axis=1)


def recenter_poses(poses: np.ndarray):
    """Recenter onto the average pose. Returns (new_poses, transform[4,4])."""
    cam2world = average_pose(poses)
    transform = np.linalg.inv(pad_pose(cam2world[None])[0])
    poses = transform @ pad_pose(poses)
    return poses[..., :3, :4], transform


def normalize_poses_pca(poses: np.ndarray):
    """Align principal axes of camera positions with XYZ, fit to unit cube.

    Returns (poses [N,3,4], transform [4,4]). `transform` maps original world
    coordinates to normalized coordinates; its isotropic scale
    (`pose_scale(transform)`) is the factor by which all metric depths must
    be multiplied to live in the normalized scene. The sign is flipped so
    the mean camera-up has +z.
    """
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    centered = t - t_mean

    eigval, eigvec = np.linalg.eig(centered.T @ centered)
    order = np.argsort(eigval)[::-1]
    rot = np.real(eigvec[:, order]).T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1.0, 1.0, -1.0]) @ rot

    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    new_poses = (pad_pose(transform[None])[0] @ pad_pose(poses))[:, :3, :4]
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)

    if new_poses.mean(axis=0)[2, 1] < 0:
        flip = np.diag([1.0, -1.0, -1.0])
        new_poses = flip @ new_poses
        transform = np.diag([1.0, -1.0, -1.0, 1.0]) @ transform

    scale = 1.0 / np.max(np.abs(new_poses[:, :3, 3]))
    new_poses[:, :3, 3] *= scale
    transform = np.diag([scale] * 3 + [1.0]) @ transform
    return new_poses, transform


def normalize_poses_min_norm(poses: np.ndarray, points: Optional[np.ndarray] = None):
    """NGP-style normalization: premultiply every pose by the inverse of the
    average camera frame (`average_pose`, rotation and translation), then
    divide the translations by the smallest camera distance, so the nearest
    camera sits at unit distance. Returns (poses [N, 3, 4], scale); depths
    divide by `scale`."""
    avg = np.eye(4)
    avg[:3] = average_pose(poses, points)
    bottom = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]), (len(poses), 1, 4))
    homo = np.concatenate([poses[:, :3, :4], bottom], axis=1)
    out = (np.linalg.inv(avg) @ homo)[:, :3]
    scale = float(np.linalg.norm(out[:, :3, 3], axis=-1).min())
    out = out.copy()
    out[:, :3, 3] /= scale
    return out, scale


def rays_to_ndc(origins: torch.Tensor, directions: torch.Tensor, pixtocam, near: float = 1.0):
    """Map world-space rays into normalized device coordinates (NeRF's
    Appendix C, for forward-facing scenes): a pinhole camera at the identity
    pose looking down -z. Origins slide to the near plane, then the t = 0
    and t = inf points are projected, so `origins_ndc + s * directions_ndc`
    for s in [0, 1] spans the frustum from the near plane to infinity (NDC z
    from -1 to 1). The returned directions are not unit length."""
    t_near = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t_near[..., None] * directions
    ox, oy, oz = origins.unbind(-1)
    dx, dy, dz = directions.unbind(-1)
    # 1 / cx' and 1 / cy' of the NDC viewport: pixtocam[0, 2] = -cx / f.
    xmult = 1.0 / float(pixtocam[0, 2])
    ymult = 1.0 / float(pixtocam[1, 2])
    origins_ndc = torch.stack([xmult * ox / oz, ymult * oy / oz, -torch.ones_like(oz)], dim=-1)
    infinity_ndc = torch.stack([xmult * dx / dz, ymult * dy / dz, torch.ones_like(oz)], dim=-1)
    return origins_ndc, infinity_ndc - origins_ndc


def fundamental_matrix(K1, w2c1, K2, w2c2) -> np.ndarray:
    """F with x2^T F x1 = 0 for corresponding homogeneous pixels: the
    relative pose from camera 1 to camera 2, the essential matrix [t]x R,
    lifted to pixels through the inverse intrinsics."""
    rel = np.asarray(w2c2) @ np.linalg.inv(np.asarray(w2c1))
    R, t = rel[:3, :3], rel[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return np.linalg.inv(np.asarray(K2)).T @ (tx @ R) @ np.linalg.inv(np.asarray(K1))


def epipolar_line(pixel_xy, F) -> np.ndarray:
    """The line (a, b, c), ax + by + c = 0, in image 2 of a pixel of image 1,
    scaled so (a, b) is a unit vector."""
    x = np.array([pixel_xy[0], pixel_xy[1], 1.0])
    line = np.asarray(F) @ x
    return line / (np.linalg.norm(line[:2]) + 1e-12)


def pose_scale(transform: np.ndarray) -> float:
    """Isotropic scale of a normalization transform (metric -> scene units)."""
    return float(np.sqrt((transform[:3, :3] @ transform[:3, :3].T)[0, 0]))


# --------------------------------------------------------------------------
# Render paths, in numpy on the host.
# --------------------------------------------------------------------------


def focus_point(poses: np.ndarray) -> np.ndarray:
    """Least-squares closest point to all camera optical axes."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.squeeze(-np.linalg.inv(mt_m.mean(0)) @ (mt_m @ -origins).mean(0))


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120, z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
    """Inward-facing elliptical render path through the camera ring."""
    center = focus_point(poses) * np.array([1.0, 1.0, 0.0])
    offset = np.array([center[0], center[1], 0.0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    zlo, zhi = np.percentile(poses[:, :3, 3], [10, 90], axis=0)

    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    positions = np.stack(
        [
            sc[0] * np.cos(theta) + offset[0],
            sc[1] * np.sin(theta) + offset[1],
            z_variation
            * (zlo[2] + (zhi - zlo)[2] * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ],
        axis=-1,
    )
    avg_up = _normalize(poses[:, :3, 1].sum(0))
    return np.stack([view_matrix(p - center, avg_up, p) for p in positions])


def generate_spiral_path(poses: np.ndarray, bounds, n_frames: int = 120, n_rots: int = 2,
                         zrate: float = 0.5) -> np.ndarray:
    """Forward-facing spiral render path (LLFF-style).

    The focus depth is a disparity-space blend of stretched near/far bounds;
    the spiral radii are the 90th percentile of camera positions; every
    camera looks at the focus point along the average pose's -z.
    """
    bounds = np.asarray(bounds, np.float64).reshape(-1)
    near_bound = bounds.min() * 0.9
    far_bound = bounds.max() * 5.0
    focal = 1.0 / ((1 - 0.75) / near_bound + 0.75 / far_bound)

    radii = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)
    radii = np.concatenate([radii, [1.0]])

    cam2world = pad_pose(average_pose(poses)[None])[0]
    up = poses[:, :3, 1].mean(0)
    render_poses = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
        position = (cam2world @ t)[:3]
        lookat = (cam2world @ np.array([0.0, 0, -focal, 1.0]))[:3]
        render_poses.append(view_matrix(position - lookat, up, position))
    return np.stack(render_poses)


def generate_spline_path(poses: np.ndarray, n_interp: int = 10, spline_degree: int = 5,
                         smoothness: float = 0.03, rot_weight: float = 0.1) -> np.ndarray:
    """Smooth B-spline through keyframe poses.

    Poses are lifted to (position, lookat-point, up-point) triplets so
    rotation interpolates as geometry; returns `n_interp * (n-1)` poses.
    """
    import scipy.interpolate

    pos = poses[:, :3, 3]
    lookat = pos - rot_weight * poses[:, :3, 2]
    up_pt = pos + rot_weight * poses[:, :3, 1]
    points = np.stack([pos, lookat, up_pt], axis=1)  # [n, 3, 3]

    n = n_interp * (points.shape[0] - 1)
    flat = points.reshape(points.shape[0], -1)
    k = min(spline_degree, flat.shape[0] - 1)
    tck, _ = scipy.interpolate.splprep(flat.T, k=k, s=smoothness)
    u = np.linspace(0, 1, n, endpoint=False)
    new = np.array(scipy.interpolate.splev(u, tck)).T.reshape(n, 3, 3)
    return np.stack([view_matrix(p - l, u_ - p, p) for p, l, u_ in new])
