"""Ray datasets, the driving-scene loader and the prefetching batcher.

Port of the reference package's `data/datasets.py`, for one process:
`RayDataset`, `PrefetchIterator`, the in-memory `SyntheticDataset` and
`SphereSceneDataset`, the driving-scene and NeRF++ layouts
(`DrivingSceneDataset`, `NerfppSceneDataset`), and the public scene
readers `BlenderDataset`, `TanksAndTemplesDataset`,
`TanksAndTemplesFVSDataset`, `DTUDataset`, `NSVFDataset` and `RTMVDataset`,
with the helpers they use (`load_image`, `decode_depth_png`,
`split_indices`, `trace_sphere_scene`, `decompose_projection`). Images and random
draws stay in numpy with the same RNG streams, so a seed gives the same
batches as the reference; batches come out as dataclasses of CPU tensors.
Train batches carry `Pixels` (cast to rays on the GPU inside the step); eval
batches are cast on the host. PNGs are read with the port's own codec
(`data/png.py`); a JPEG input (the Free View Synthesis layout allows
`im_*.jpg`) raises ValueError.
"""

from __future__ import annotations

import json
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


class SphereSceneDataset(RayDataset):
    """Deterministic analytic 3D scene rendered by closed-form ray casting.

    Shaded spheres over a ground disk on a black background, which a NeRF
    can and must fit: the scene of `tools/quality_gate.py` and
    `configs/spheres_ablation.json`. Geometry fits inside the unit sphere
    (NeRF++) and the [-0.5, 0.5] cube (NGP scale 0.5); cameras ring at
    radius 0.95. Depths are exact; background pixels carry invalid depth.
    """

    def __init__(
        self,
        split: str = "train",
        global_batch_size: int = 128,
        n_images: int = 24,
        height: int = 64,
        width: int = 96,
        cast_on_device: bool = True,
        sample_every: int = 1,
        depth_sup_type: str = "gt",
    ):
        """`sample_every` subsamples train views (sparse-view protocol);
        `depth_sup_type` selects the depth-prior emulation:

          * gt          - exact analytic depth
          * stereo_like - disparity-domain Gaussian noise (sigma_z ~ z^2)
            plus 15% holes, the error profile of stereo priors
          * mono_like   - per-image affine miscalibration times a smooth
            low-frequency field, the error profile of monocular priors
          * rgbonly     - no depth supervision (all pixels invalid)
        """
        super().__init__(split, global_batch_size, cast_on_device)
        self._centers = np.array(
            [[0.18, 0.0, -0.05], [-0.15, 0.14, -0.1], [-0.02, -0.18, 0.02]], np.float32)
        self._radii = np.array([0.16, 0.13, 0.11], np.float32)
        self._colors = np.array(
            [[0.85, 0.25, 0.2], [0.2, 0.7, 0.85], [0.9, 0.8, 0.25]], np.float32)
        self._ground_z = -0.25
        self._ground_r = 0.45
        self._light = np.array([0.45, -0.3, 0.84], np.float32)
        self._light /= np.linalg.norm(self._light)

        idx = split_indices(n_images, split, sample_every)
        poses = []
        for i in range(n_images):
            ang = 2 * np.pi * i / n_images
            pos = np.array([0.9 * np.cos(ang), 0.9 * np.sin(ang), 0.3], np.float32)
            poses.append(cameras_lib.view_matrix(pos, np.array([0.0, 0, 1.0]), pos))
        self.camtoworlds = np.stack(poses).astype(np.float32)[idx]
        self.pixtocams = cameras_lib.pinhole_pixtocam(
            focal=width * 0.9, width=width, height=height).astype(np.float32)
        self.near, self.far = 0.05, 4.0

        traced = [
            trace_sphere_scene(c2w, self.pixtocams, height, width, self.near, self._centers,
                               self._radii, self._colors, self._light, self._ground_z,
                               self._ground_r)
            for c2w in self.camtoworlds
        ]
        self.images = np.stack([rgb for rgb, _ in traced])
        self.depth_gt = np.stack([depth for _, depth in traced])
        self.depth_sup = self._make_depth_prior(depth_sup_type)
        self._finalize()

    def _make_depth_prior(self, depth_sup_type: str) -> np.ndarray:
        d = self.depth_gt
        valid = d > 0
        if depth_sup_type == "gt":
            return d.copy()
        if depth_sup_type == "rgbonly":
            return np.zeros_like(d)
        rng = np.random.RandomState(7)  # deterministic priors
        if depth_sup_type == "stereo_like":
            # Constant disparity noise => sigma_z = sigma_disp * z^2, plus
            # matching-failure holes.
            sigma_disp = 0.02
            noisy = d + rng.normal(0.0, 1.0, d.shape).astype(np.float32) * (sigma_disp * d**2)
            holes = rng.uniform(size=d.shape) < 0.15
            return np.where(valid & ~holes, np.maximum(noisy, 0.0), 0.0).astype(np.float32)
        if depth_sup_type == "mono_like":
            sup = np.zeros_like(d)
            h, w = d.shape[1:3]
            gy = np.linspace(0.0, np.pi, h, dtype=np.float32)[:, None]
            gx = np.linspace(0.0, np.pi, w, dtype=np.float32)[None, :]
            for i in range(d.shape[0]):
                a = 1.0 + rng.uniform(-0.15, 0.15)
                b = rng.uniform(-0.03, 0.03)
                field = 1.0 + 0.08 * np.sin(
                    gy * rng.randint(1, 3) + rng.uniform(0, 3)
                ) * np.sin(gx * rng.randint(1, 3) + rng.uniform(0, 3))
                sup[i] = (a * d[i] + b) * field
            return np.where(valid, np.maximum(sup, 0.0), 0.0).astype(np.float32)
        raise ValueError(f"unknown spheres depth_sup_type {depth_sup_type!r}")


class DrivingSceneDataset(RayDataset):
    """COLMAP driving scene in the DTU_format layout.

    scene_dir/
      sparse/0/{cameras,images,points3D}.{bin,txt}
      images[_<factor>]/*.png
      depths_gt[_<factor>]/*.png          (uint16, /256 -> metres)
      depths_<sup_type>[_<factor>]/*.png  (the depth prior under supervision;
                                           also spelled depths_<factor>_<sup_type>)

    Poses are PCA-normalized; the normalization's scale multiplies every
    depth and, with `auto_adjust_near_far`, near and far. A COLMAP camera's
    lens distortion and fisheye model (SIMPLE_RADIAL, RADIAL, OPENCV,
    OPENCV_FISHEYE) go with the cameras to every ray cast.
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
    `skip` keeps every skip-th view; `max_depth_default` scales the min-depth
    maps of a split without max_depth.txt.
    """

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        skip: int = 1,
        depth_sup_type: str = "gt",
        max_depth_default: float = 100.0,
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

        max_depth = max_depth_default  # without max_depth.txt
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


def _composite(img: np.ndarray, background: float) -> np.ndarray:
    """An RGBA image over a constant background; RGB and grey pass through."""
    if img.ndim == 3 and img.shape[-1] == 4:
        a = img[..., 3:]
        img = img[..., :3] * a + (1.0 - a) * background
    return img


class BlenderDataset(RayDataset):
    """Blender / NGP `transforms_{split}.json` synthetic scenes.

    RGBA images composited over white (or black), the focal from
    `camera_angle_x`, camera-to-world matrices already in OpenGL axes.
    """

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        near: float = 2.0,
        far: float = 6.0,
        white_background: bool = True,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
            meta = json.load(f)

        images, poses = [], []
        for frame in meta["frames"]:
            path = os.path.join(scene_dir, frame["file_path"])
            if not os.path.splitext(path)[1]:
                path += ".png"
            img = load_image(path) / 255.0
            images.append(_composite(img, 1.0 if white_background else 0.0).astype(np.float32))
            poses.append(np.asarray(frame["transform_matrix"])[:3, :4])
        self.images = np.stack(images)
        self.camtoworlds = np.stack(poses).astype(np.float32)

        h, w = self.images.shape[1:3]
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        self.pixtocams = cameras_lib.pinhole_pixtocam(focal, w, h).astype(np.float32)
        self.near, self.far = near, far
        self._finalize()


class TanksAndTemplesDataset(NerfppSceneDataset):
    """Tanks and Temples as processed by NeRF++: the same per-image txt
    layout (`{split}/{intrinsics,pose,rgb}`, cameras in the unit sphere), so
    `NerfppSceneDataset`'s reader and bounds apply unchanged."""


class TanksAndTemplesFVSDataset(RayDataset):
    """Tanks and Temples as processed by Free View Synthesis.

    scene_dir/dense/ibr3d_*/{im_*.png, Ks.npy, Rs.npy, ts.npy}: the ibr3d_*
    directories are a resolution pyramid (sorted descending), and `factor`
    picks a level. Poses are COLMAP world-to-camera (Ks/Rs/ts), inverted,
    flipped to OpenGL and PCA-normalized; near and far scale with the
    normalization. Every `llffhold`-th image is test.
    """

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        factor: int = 0,
        llffhold: int = 8,
        near: float = 0.01,
        far: float = 10.0,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        basedir = os.path.join(scene_dir, "dense")
        sizes = sorted(f for f in os.listdir(basedir) if f.startswith("ibr3d"))[::-1]
        if factor >= len(sizes):
            raise ValueError(f"factor {factor} >= {len(sizes)} pyramid levels")
        basedir = os.path.join(basedir, sizes[factor])

        files = sorted(f for f in os.listdir(basedir) if f.startswith("im_"))
        images = np.stack([load_image(os.path.join(basedir, f)) for f in files])
        Ks = np.load(os.path.join(basedir, "Ks.npy"))
        Rs = np.load(os.path.join(basedir, "Rs.npy"))
        ts = np.load(os.path.join(basedir, "ts.npy"))

        # world-to-camera -> camera-to-world, then OpenCV -> OpenGL columns.
        w2c = np.concatenate([Rs, ts[..., None]], axis=-1)
        bottom = np.tile(np.array([[[0.0, 0, 0, 1]]]), (len(w2c), 1, 1))
        c2w = np.linalg.inv(np.concatenate([w2c, bottom], axis=1))[:, :3, :4]
        c2w = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])
        poses, transform = cameras_lib.normalize_poses_pca(c2w)
        self.scene_scale = cameras_lib.pose_scale(transform)

        idx = np.arange(len(files))
        idx = idx[idx % llffhold == 0] if split == "test" else idx[idx % llffhold != 0]
        self.images = (images[idx] / 255.0).astype(np.float32)
        self.camtoworlds = poses[idx].astype(np.float32)
        self.pixtocams = np.linalg.inv(Ks[idx].astype(np.float32))
        self.near, self.far = near * self.scene_scale, far * self.scene_scale
        self._finalize()


def decompose_projection(P: np.ndarray):
    """Split a 3x4 projection into (K, R, camera_center) by an RQ
    decomposition: K normalized to K[2,2] = 1 with a positive diagonal, R
    world-to-camera."""
    import scipy.linalg

    M = P[:, :3]
    K, R = scipy.linalg.rq(M)
    # RQ is unique only up to signs: make K's diagonal positive.
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    K = K * signs[None, :]
    R = R * signs[:, None]
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    t = np.linalg.solve(K, P[:, 3])
    center = -R.T @ t
    return K / K[2, 2], R, center


class DTUDataset(RayDataset):
    """DTU MVS scans.

    The scan directory holds `rect_{i:03d}_{light}.png` (light
    `{cond}_r5000` / `_r7000`, or `max` when `light_cond` is 7) and the
    projection matrices `../../cal18/pos_{i:03d}.txt` (or a local `cal18/`).
    Poses are recentered, scaled by the largest |xyz| and flipped to
    OpenGL. Every `dtuhold`-th image is test.
    """

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        light_cond: int = 7,
        dtuhold: int = 8,
        near: float = 0.1,
        far: float = 5.0,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        if light_cond < 7:
            n_images = len([f for f in os.listdir(scene_dir) if f.startswith("rect_")]) // 8
        else:
            n_images = len([f for f in os.listdir(scene_dir) if f.endswith("_max.png")])
        cal_dir = os.path.join(scene_dir, "../../cal18")
        if not os.path.isdir(cal_dir):
            cal_dir = os.path.join(scene_dir, "cal18")

        images, pixtocams, camtoworlds = [], [], []
        for i in range(1, n_images + 1):
            if light_cond < 7:
                light = f"{light_cond}_r" + ("5000" if i < 50 else "7000")
            else:
                light = "max"
            images.append(load_image(os.path.join(scene_dir, f"rect_{i:03d}_{light}.png")) / 255.0)
            P = np.loadtxt(os.path.join(cal_dir, f"pos_{i:03d}.txt")).reshape(3, 4)
            K, R, center = decompose_projection(P)
            camtoworlds.append(np.concatenate([R.T, center[:, None]], axis=1))
            pixtocams.append(np.linalg.inv(K))

        camtoworlds = np.stack(camtoworlds)
        camtoworlds, _ = cameras_lib.recenter_poses(camtoworlds)
        camtoworlds[:, :3, 3] /= np.max(np.abs(camtoworlds[:, :3, 3]))
        camtoworlds = camtoworlds @ np.diag([1.0, -1.0, -1.0, 1.0])

        idx = np.arange(n_images)
        idx = idx[idx % dtuhold == 0] if split == "test" else idx[idx % dtuhold != 0]
        self.images = np.stack(images)[idx].astype(np.float32)
        self.camtoworlds = camtoworlds[idx].astype(np.float32)
        self.pixtocams = np.stack(pixtocams)[idx].astype(np.float32)
        self.near, self.far = near, far
        self._finalize()


class NSVFDataset(RayDataset):
    """NSVF-format scenes.

    scene_dir/{intrinsics.txt, bbox.txt, rgb/<p>_*.png, pose/<p>_*.txt},
    where the file prefix names the split (0_ train, 1_ val and test, 2_ the
    synthetic scenes' test). Poses are camera-to-world in OpenCV axes; the
    camera centres are shifted and scaled so the bbox fits in [-0.5, 0.5]^3
    (the NGP AABB).
    """

    _PREFIX = {"train": "0_", "val": "1_", "test": "1_", "test_synthetic": "2_"}

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        near: float = 0.01,
        far: float = 4.0,
        white_background: bool = True,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        K_raw = np.loadtxt(os.path.join(scene_dir, "intrinsics.txt"))
        bbox = np.loadtxt(os.path.join(scene_dir, "bbox.txt")).reshape(-1)[:6]
        xyz_min, xyz_max = bbox[:3], bbox[3:6]
        self.shift = (xyz_max + xyz_min) / 2
        self.scale = float((xyz_max - xyz_min).max() / 2 * 1.05)

        prefix = self._PREFIX.get(split)
        if prefix is None:
            raise ValueError(f"unknown NSVF split {split!r}")
        rgb_dir = os.path.join(scene_dir, "rgb")
        pose_dir = os.path.join(scene_dir, "pose")
        files = sorted(f for f in os.listdir(rgb_dir) if f.startswith(prefix))
        pose_files = sorted(f for f in os.listdir(pose_dir) if f.startswith(prefix))
        if not files:
            # Synthetic scenes name their test split with prefix 2_.
            files = sorted(f for f in os.listdir(rgb_dir) if f.startswith("2_"))
            pose_files = sorted(f for f in os.listdir(pose_dir) if f.startswith("2_"))

        images, poses = [], []
        flip = np.diag([1.0, -1.0, -1.0])
        for rgb_f, pose_f in zip(files, pose_files):
            img = load_image(os.path.join(rgb_dir, rgb_f)) / 255.0
            images.append(_composite(img, 1.0 if white_background else 0.0).astype(np.float32))
            c2w = np.loadtxt(os.path.join(pose_dir, pose_f)).reshape(4, 4)[:3].copy()
            c2w[:, 3] = (c2w[:, 3] - self.shift) / (2 * self.scale)
            poses.append(np.concatenate([c2w[:, :3] @ flip, c2w[:, 3:4]], -1))
        self.images = np.stack(images)
        self.camtoworlds = np.stack(poses).astype(np.float32)

        h, w = self.images.shape[1:3]
        if K_raw.ndim == 0 or K_raw.size == 1:
            K = np.array([[float(K_raw), 0, w / 2], [0, float(K_raw), h / 2], [0, 0, 1]])
        else:
            K = K_raw.reshape(-1)[:9].reshape(3, 3)
        self.pixtocams = np.linalg.inv(K).astype(np.float32)
        self.near, self.far = near, far
        self._finalize()


class RTMVDataset(RayDataset):
    """RTMV synthetic scenes.

    scene_dir/{NNNNN.json, images/NNNNN.png}: each frame's json holds the
    intrinsics, `cam2world` (column-major) and the scene's 3D box. Splits
    are index ranges: train 0-100, trainval 0-105, test 105-150, all.
    With `normalize_box` the camera centres are shifted and scaled so the
    box fits in [-0.5, 0.5]^3.
    """

    _RANGES = {"train": (0, 100), "trainval": (0, 105), "test": (105, 150), "all": (0, None)}

    def __init__(
        self,
        scene_dir: str,
        split: str,
        global_batch_size: int,
        near: float = 0.01,
        far: float = 4.0,
        normalize_box: bool = True,
        cast_on_device: bool = True,
    ):
        super().__init__(split, global_batch_size, cast_on_device)
        jsons = sorted(f for f in os.listdir(scene_dir) if f.endswith(".json"))
        img_dir = os.path.join(scene_dir, "images")
        img_files = sorted(os.listdir(img_dir))
        lo, hi = self._RANGES.get(split, (0, None))
        jsons, img_files = jsons[lo:hi], img_files[lo:hi]

        with open(os.path.join(scene_dir, jsons[0])) as f:
            meta = json.load(f)["camera_data"]
        self.shift = np.asarray(meta["scene_center_3d_box"], np.float64)
        self.scale = float((np.asarray(meta["scene_max_3d_box"])
                            - np.asarray(meta["scene_min_3d_box"])).max() / 2 * 1.05)
        intr = meta["intrinsics"]
        K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
        self.pixtocams = np.linalg.inv(K).astype(np.float32)

        images, poses = [], []
        for jf, imf in zip(jsons, img_files):
            with open(os.path.join(scene_dir, jf)) as f:
                cam = json.load(f)["camera_data"]
            c2w = np.asarray(cam["cam2world"]).T[:3].copy()
            c2w[:, 1:3] *= -1  # OpenCV -> OpenGL
            if normalize_box:
                c2w[:, 3] = (c2w[:, 3] - self.shift) / (2 * self.scale)
            poses.append(c2w)
            img = load_image(os.path.join(img_dir, imf)) / 255.0
            images.append(_composite(img, 1.0).astype(np.float32))
        self.images = np.stack(images)
        self.camtoworlds = np.stack(poses).astype(np.float32)
        self.near, self.far = near, far
        self._finalize()
