"""Pinhole cameras and pixel->ray casting with mip-NeRF cone radii.

Port of the part of the reference package's `data/cameras.py` that the
mip-NeRF train path uses: camera setup in numpy on the host
(`pinhole_pixtocam`, `pixel_grid`, `view_matrix`) and the cast of pixels to
rays in torch, on whichever device the tensors live (the train step casts on
the GPU). Perspective cameras without lens distortion only; fisheye and
distortion raise NotImplementedError.
"""

from __future__ import annotations

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


def pixels_to_rays(pix_x, pix_y, pixtocams, camtoworlds, distortion=None, camtype="perspective"):
    """Cast rays through pixel centers, with mip-NeRF cone radii.

    Vectorized over leading dims of pix_x/pix_y; pixtocams [.., 3, 3] and
    camtoworlds [.., 3, 4] broadcast against them. Returns (origins,
    directions, viewdirs, radii, imageplane).
    """
    if distortion is not None or camtype != "perspective":
        raise NotImplementedError("only undistorted perspective cameras are ported")
    mk = lambda x, y: torch.stack([x + 0.5, y + 0.5, torch.ones_like(x)], dim=-1)
    trio = torch.stack([mk(pix_x, pix_y), mk(pix_x + 1, pix_y), mk(pix_x, pix_y + 1)])
    mat_vec = lambda a, v: (a @ v[..., None])[..., 0]

    cam_dirs = mat_vec(pixtocams, trio)
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
