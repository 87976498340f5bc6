"""Ray datasets and the prefetching batcher.

Port of `RayDataset`, `SyntheticDataset` and `PrefetchIterator` from the
reference package's `data/datasets.py`, for one process. Images and random
draws stay in numpy with the same RNG streams, so a seed gives the same
batches as the reference; batches come out as dataclasses of CPU tensors.
Train batches carry `Pixels` (cast to rays on the GPU inside the step); eval
batches are cast on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib

_INVALID_DEPTH = -1.0


class RayDataset:
    """Base: holds per-image arrays, serves random-pixel train batches.

    Subclasses populate (before calling `_finalize`): images [N,H,W,3] in
    [0,1]; camtoworlds [N,3,4]; pixtocams [3,3] or [N,3,3]; near/far
    floats; depth_gt / depth_sup [N,H,W] (invalid <= 0) or None.
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
        pixels = rays_lib.Pixels(
            pix_x=t(px.astype(np.float32)),
            pix_y=t(py.astype(np.float32)),
            cam_idx=t(cam_idx[..., None].astype(np.int32)),
            lossmult=t(np.ones(px.shape + (1,), np.float32)),
            near=t(np.full(px.shape + (1,), self.near, np.float32)),
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
