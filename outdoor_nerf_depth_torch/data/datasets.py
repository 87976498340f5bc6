"""Ray datasets, the driving-scene loader and the prefetching batcher.

Port of `RayDataset`, `SyntheticDataset`, `DrivingSceneDataset`,
`NerfppSceneDataset`, `PrefetchIterator` and the helpers they use (`load_image`,
`decode_depth_png`, `split_indices`, `trace_sphere_scene`) from the
reference package's `data/datasets.py`, for one process. Images and random
draws stay in numpy with the same RNG streams, so a seed gives the same
batches as the reference; batches come out as dataclasses of CPU tensors.
Train batches carry `Pixels` (cast to rays on the GPU inside the step); eval
batches are cast on the host. PNGs are read with the port's own codec
(`data/png.py`).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import colmap
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.data import rays as rays_lib

_INVALID_DEPTH = -1.0


def load_image(path: str) -> np.ndarray:
    """Load a PNG as float32 numpy; 16-bit PNGs keep their raw values. The
    port has no JPEG decoder, so a `.jpg`/`.jpeg` path raises ValueError."""
    if path.lower().endswith((".jpg", ".jpeg")):
        raise ValueError(f"{path}: the port reads PNG images only (it has no JPEG decoder); "
                         "convert the images to PNG")
    return png.read_png(path).astype(np.float32)


def decode_depth_png(
    raw: np.ndarray,
    scene_scale: float,
    invalid_below: float = 2.0,
    crop_range: float = 0.0,
    keep_ratio: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """KITTI-convention uint16 depth decode with validity filtering.

    raw/256 is metres; raw < `invalid_below` marks no-return pixels. Invalid
    pixels become negative (so `depth > 0` masks remain valid after any
    positive rescale). `crop_range` (metres) invalidates far returns;
    `keep_ratio` keeps a deterministic random subset of valid pixels with
    total-image density `keep_ratio`. Finally everything valid is multiplied
    by `scene_scale` (the pose-normalization scale).
    """
    depth = raw.astype(np.float32)
    invalid = depth < invalid_below
    depth = depth / 256.0
    if crop_range > 0:
        invalid |= depth > crop_range
    if keep_ratio > 0:
        valid_frac = np.count_nonzero(~invalid) / depth.size
        if keep_ratio >= valid_frac:
            raise ValueError(
                f"keep_ratio {keep_ratio} >= available density {valid_frac:.4f}"
            )
        rng = np.random.RandomState(seed)
        keep = rng.uniform(size=depth.shape) < (keep_ratio / valid_frac)
        invalid |= ~keep
    depth = depth * scene_scale
    depth[invalid] = _INVALID_DEPTH
    return depth


def split_indices(n_images: int, split: str, sample_every: int = 1):
    """The view split: test = every 10th image starting at 9.

    Train is the complement subsampled by `sample_every` (the sparse-view
    protocol).
    """
    test = list(range(9, n_images, 10))
    if split == "test":
        return np.array(test, dtype=np.int32)
    train = sorted(set(range(n_images)) - set(test))
    return np.array(train[::max(1, sample_every)], dtype=np.int32)


class RayDataset:
    """Base: holds per-image arrays, serves random-pixel train batches.

    Subclasses populate (before calling `_finalize`): images [N,H,W,3] in
    [0,1]; camtoworlds [N,3,4]; pixtocams [3,3] or [N,3,3]; near/far
    floats; depth_gt / depth_sup [N,H,W] (invalid <= 0) or None; min_depth
    [N,H,W] or None (NeRF++'s per-ray near bound).
    """

    images: np.ndarray
    camtoworlds: np.ndarray
    pixtocams: np.ndarray
    distortion = None
    camtype: str = "perspective"
    near: float = 0.1
    far: float = 100.0
    depth_gt: Optional[np.ndarray] = None
    depth_sup: Optional[np.ndarray] = None
    min_depth: Optional[np.ndarray] = None
    scene_scale: float = 1.0

    def __init__(self, split: str, global_batch_size: int, cast_on_device: bool = True):
        self.split = split
        self.cast_on_device = cast_on_device
        self.batch_size = global_batch_size
        self._rng = np.random.default_rng(20230717)

    def _finalize(self):
        self.n_images, self.height, self.width = self.images.shape[:3]
        self.cameras = (
            self.pixtocams.astype(np.float32),
            self.camtoworlds.astype(np.float32),
            self.distortion,
        )

    def cameras_on(self, device):
        """(pixtocams, camtoworlds, distortion) as tensors on `device`."""
        pixtocams, camtoworlds, distortion = self.cameras
        return (
            torch.as_tensor(pixtocams, device=device),
            torch.as_tensor(camtoworlds, device=device),
            distortion,
        )

    def _gather(self, cam_idx, py, px, cast: bool) -> rays_lib.Batch:
        t = torch.from_numpy
        # NeRF++'s min_depth maps give each ray its own near bound.
        if self.min_depth is not None:
            near = self.min_depth[cam_idx, py, px][..., None].astype(np.float32)
        else:
            near = np.full(px.shape + (1,), self.near, np.float32)
        pixels = rays_lib.Pixels(
            pix_x=t(px.astype(np.float32)),
            pix_y=t(py.astype(np.float32)),
            cam_idx=t(cam_idx[..., None].astype(np.int32)),
            lossmult=t(np.ones(px.shape + (1,), np.float32)),
            near=t(near),
            far=t(np.full(px.shape + (1,), self.far, np.float32)),
        )
        rays = cameras_lib.cast_pixels(pixels, self.cameras_on("cpu"), self.camtype) if cast else pixels
        pick = lambda a: None if a is None else t(np.ascontiguousarray(a[cam_idx, py, px]))
        return rays_lib.Batch(
            rays=rays,
            rgb=t(np.ascontiguousarray(self.images[cam_idx, py, px])),
            depth_gt=pick(self.depth_gt),
            depth_sup=pick(self.depth_sup),
        )

    def sample_batch(self) -> rays_lib.Batch:
        """Random rays across all images."""
        n = self.batch_size
        cam_idx = self._rng.integers(0, self.n_images, (n,))
        px = self._rng.integers(0, self.width, (n,))
        py = self._rng.integers(0, self.height, (n,))
        cast = not (self.cast_on_device and self.split == "train")
        return self._gather(cam_idx, py, px, cast)

    def image_batch(self, idx: int) -> rays_lib.Batch:
        """All rays of one image, cast on the host ([H, W, ...] leaves)."""
        px, py = cameras_lib.pixel_grid(self.width, self.height)
        cam_idx = np.full(px.shape, idx, np.int32)
        return self._gather(cam_idx, py, px, cast=True)


class PrefetchIterator:
    """Daemon-thread prefetch with a bounded queue (depth 3)."""

    def __init__(self, make_batch, depth: int = 3):
        self._queue = queue.Queue(depth)
        self._make = make_batch
        # Seed one batch synchronously so consumers never race the thread.
        self._queue.put(self._make())
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            self._queue.put(self._make())

    def __iter__(self):
        return self

    def __next__(self):
        return self._queue.get()


class SyntheticDataset(RayDataset):
    """In-memory random scene: the no-disk test/benchmark fixture."""

    def __init__(
        self,
        split: str = "train",
        global_batch_size: int = 128,
        n_images: int = 4,
        height: int = 8,
        width: int = 12,
        with_depth: bool = True,
        seed: int = 0,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(size=(n_images, height, width, 3)).astype(np.float32)
        # Cameras on a ring looking inward at the origin.
        poses = []
        for i in range(n_images):
            ang = 2 * np.pi * i / n_images
            pos = np.array([np.cos(ang), np.sin(ang), 0.3]) * 0.5
            poses.append(cameras_lib.view_matrix(pos, np.array([0.0, 0, 1]), pos))
        self.camtoworlds = np.stack(poses).astype(np.float32)
        self.pixtocams = cameras_lib.pinhole_pixtocam(
            focal=width * 1.2, width=width, height=height
        ).astype(np.float32)
        self.near, self.far = 0.05, 10.0
        if with_depth:
            d = rng.uniform(1.0, 8.0, (n_images, height, width)).astype(np.float32)
            mask = rng.uniform(size=d.shape) < 0.7
            self.depth_gt = np.where(mask, d, _INVALID_DEPTH).astype(np.float32)
            self.depth_sup = np.where(
                mask, d + rng.normal(0, 0.05, d.shape), _INVALID_DEPTH
            ).astype(np.float32)
        self._finalize()


def trace_sphere_scene(
    c2w,
    pixtocam,
    height: int,
    width: int,
    near: float,
    centers,
    radii,
    colors,
    light,
    ground_z: float,
    ground_r: float,
    ground_center=(0.0, 0.0),
):
    """Closed-form ray casting of the analytic sphere+ground-disk scene.

    Returns (rgb [H, W, 3] in [0,1], depth [H, W] metric along the ray,
    invalid = _INVALID_DEPTH), in float32 and bit for bit the reference's,
    so the fixture writer (`tools/make_kitti_fixture.py`) stores the same
    pixels and depth codes.
    """
    px, py = cameras_lib.pixel_grid(width, height)
    cam_idx = np.zeros(px.shape, np.int32)
    o, d = cameras_lib.ray_origins_and_viewdirs_np(
        px.astype(np.float32), py.astype(np.float32), pixtocam, c2w[None][cam_idx]
    )
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)

    t_hit = np.full(px.shape, np.inf, np.float32)
    rgb = np.zeros(px.shape + (3,), np.float32)

    # Spheres: nearest positive root of |o + t d - c|^2 = r^2.
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

    # Ground disk at z = ground_z, radius ground_r, smooth albedo.
    tz = (ground_z - o[..., 2]) / np.where(
        np.abs(d[..., 2]) < 1e-8, 1e-8, d[..., 2]
    )
    hit_pt = o + tz[..., None] * d
    rel = hit_pt[..., :2] - np.asarray(ground_center, np.float32)
    on_disk = (
        (tz > near)
        & (tz < t_hit)
        & (np.linalg.norm(rel, axis=-1) < ground_r)
    )
    albedo = np.stack(
        [
            0.45 + 0.35 * rel[..., 0] / ground_r,
            0.5 + 0.35 * rel[..., 1] / ground_r,
            np.full(tz.shape, 0.55, np.float32),
        ],
        -1,
    )
    rgb = np.where(on_disk[..., None], albedo * light[2], rgb)
    t_hit = np.where(on_disk, tz, t_hit)

    depth = np.where(np.isfinite(t_hit), t_hit, _INVALID_DEPTH)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), depth.astype(np.float32)


class DrivingSceneDataset(RayDataset):
    """COLMAP driving scene in the DTU_format layout.

    scene_dir/
      sparse/0/{cameras,images,points3D}.{bin,txt}
      images[_<factor>]/*.png
      depths_gt[_<factor>]/*.png          (uint16, /256 -> metres)
      depths_<sup_type>[_<factor>]/*.png  (the depth prior under supervision;
                                           also spelled depths_<factor>_<sup_type>)

    Poses are PCA-normalized; the normalization's scale multiplies every
    depth and, with `auto_adjust_near_far`, near and far. Distorted and
    fisheye cameras load, and raise where their rays are cast.
    """

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        near: float = 0.1,
        far: float = 150.0,
        factor: int = 0,
        depth_sup_type: str = "gt",
        sample_every: int = 1,
        depth_crop_range: float = 0.0,
        depth_keep_ratio: float = 0.0,
        auto_adjust_near_far: bool = True,
        load_depth: bool = True,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        suffix = f"_{factor}" if factor > 0 else ""

        names, poses, pixtocam, distortion, camtype, _ = colmap.load_scene(
            os.path.join(scene_dir, "sparse/0")
        )
        order = np.argsort(names)
        names = [names[i] for i in order]
        poses = poses[order][:, :3, :4]

        if factor > 0:
            pixtocam = pixtocam @ np.diag([factor, factor, 1.0])
        self.pixtocams = pixtocam.astype(np.float32)
        self.distortion = distortion
        self.camtype = camtype

        image_dir = os.path.join(scene_dir, "images" + suffix)
        colmap_files = sorted(os.listdir(os.path.join(scene_dir, "images")))
        image_files = sorted(os.listdir(image_dir))
        to_image = dict(zip(colmap_files, image_files))
        images = np.stack(
            [load_image(os.path.join(image_dir, to_image[n])) for n in names]
        )
        self.images = (images / 255.0).astype(np.float32)

        poses, transform = cameras_lib.normalize_poses_pca(poses)
        scale = cameras_lib.pose_scale(transform)
        self.scene_scale = scale
        self.world_transform = transform
        if auto_adjust_near_far:
            near, far = near * scale, far * scale
        self.near, self.far = near, far

        depth_gt = depth_sup = None
        if load_depth:
            def load_depth_dir(dirname, crop=0.0, keep=0.0):
                ddir = os.path.join(scene_dir, dirname)
                dfiles = sorted(os.listdir(ddir))
                to_depth = dict(zip(colmap_files, dfiles))
                return np.stack(
                    [
                        decode_depth_png(
                            load_image(os.path.join(ddir, to_depth[n])),
                            scene_scale=scale,
                            crop_range=crop,
                            keep_ratio=keep,
                        )
                        for n in names
                    ]
                )

            depth_gt = load_depth_dir("depths_gt" + suffix)
            depth_sup = load_depth_dir(
                f"depths{suffix}_{depth_sup_type}"
                if os.path.isdir(os.path.join(scene_dir, f"depths{suffix}_{depth_sup_type}"))
                else f"depths_{depth_sup_type}" + suffix,
                crop=depth_crop_range,
                keep=depth_keep_ratio,
            )

        idx = split_indices(len(names), split, sample_every)
        self.images = self.images[idx]
        self.camtoworlds = poses[idx].astype(np.float32)
        self.depth_gt = None if depth_gt is None else depth_gt[idx]
        self.depth_sup = None if depth_sup is None else depth_sup[idx]
        self._finalize()


class NerfppSceneDataset(RayDataset):
    """The NeRF++ per-image txt layout (cameras normalized into the unit sphere).

    scene_dir/<split>/{intrinsics,pose}/*.txt, rgb/, depth/,
    depth_<sup_type>/, min_depth/, max_depth.txt, and scene_dir/scale.
    Depths are raw / 256 * scale, min-depth PNGs raw / 255 * max_depth.
    Poses come in OpenCV axes and are flipped to OpenGL for the caster.
    `skip` keeps every skip-th view.
    """

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        skip: int = 1,
        depth_sup_type: str = "gt",
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        split_dir = os.path.join(scene_dir, split)

        def files(sub):
            return sorted(os.listdir(os.path.join(split_dir, sub)))[::skip]

        def read_mats(sub):
            return [np.loadtxt(os.path.join(split_dir, sub, f)).reshape(4, 4) for f in files(sub)]

        intrinsics, poses = read_mats("intrinsics"), read_mats("pose")
        self.images = np.stack(
            [load_image(os.path.join(split_dir, "rgb", f)) / 255.0 for f in files("rgb")]
        ).astype(np.float32)

        # OpenCV c2w -> OpenGL c2w (flip the y and z columns).
        flip = np.diag([1.0, -1.0, -1.0])
        self.camtoworlds = np.stack(
            [np.concatenate([p[:3, :3] @ flip, p[:3, 3:4]], -1) for p in poses]
        ).astype(np.float32)
        self.pixtocams = np.stack([np.linalg.inv(k[:3, :3]) for k in intrinsics]).astype(np.float32)

        scale_file = os.path.join(scene_dir, "scale")
        if os.path.exists(scale_file):
            with open(scale_file) as f:
                self.scene_scale = float(f.read().split()[0])

        def load_depths(sub):
            if not os.path.isdir(os.path.join(split_dir, sub)):
                return None
            out = np.stack([load_image(os.path.join(split_dir, sub, f)) for f in files(sub)])
            out = out / 256.0 * self.scene_scale
            out[out <= 0] = _INVALID_DEPTH
            return out.astype(np.float32)

        self.depth_gt = load_depths("depth")
        self.depth_sup = load_depths(
            "depth" if depth_sup_type == "gt" else f"depth_{depth_sup_type}")

        max_depth = 100.0  # without max_depth.txt
        max_depth_file = os.path.join(split_dir, "max_depth.txt")
        if os.path.exists(max_depth_file):
            with open(max_depth_file) as f:
                max_depth = float(f.read().strip())
        if os.path.isdir(os.path.join(split_dir, "min_depth")):
            self.min_depth = np.stack(
                [load_image(os.path.join(split_dir, "min_depth", f)) / 255.0 * max_depth + 1e-4
                 for f in files("min_depth")]
            ).astype(np.float32)
        self.near, self.far = 1e-4, 2.0  # unit-sphere scene: fg far ~ sphere exit
        self._finalize()
