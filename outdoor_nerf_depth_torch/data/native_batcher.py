"""ctypes bridge to the C++ batch-assembly dataplane (`csrc/dataplane.cpp`).

Port of the reference package's `data/native_batcher.py`. `NativeRayBatcher`
draws a train batch of random pixels and casts their pinhole rays on the
host in multithreaded C++, and returns the port's `Batch` of CPU tensors,
which the `PrefetchIterator` and the train step take as they take a
host-cast batch. A seed and a thread count give the reference's batches bit
for bit: pixels come from SplitMix64 streams, one a thread, the batch split
into `num_threads` chunks (0 means the machine's hardware concurrency, so a
batch then depends on the core count, in the reference too).

The source is built with g++ (the reference's flags) at first use, never
at import, into `build/native/libdataplane-<hash>.so` at the repository
root, where `<hash>` is taken from the source and the flags. A failed build
raises: there is no fallback to the numpy sampler.

The dataplane ignores lens distortion and the camera type: a lensed scene
trains on pinhole rays through it, as in the reference.

In a process group each rank draws `dataset.batch_size` rays, its share of
the global batch, from a batcher seeded with the config's seed alone, as
the reference loop builds it on every process: so every rank draws the
same rays, and the global batch holds W copies of one share (a fault shared
with the reference, kept as it is).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import rays as rays_lib

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "dataplane.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdataplane-{digest}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native dataplane: g++ not found ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native dataplane: g++ failed:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The ctypes handle of the dataplane, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.sample_ray_batch.argtypes = [
                f32p, f32p, f32p, f32p, f32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64, ctypes.c_int,
                f32p, f32p, f32p, f32p, f32p, f32p, f32p, i32p,
            ]
            lib.sample_ray_batch.restype = None
            _lib = lib
        return _lib


def applies(config, dataset) -> bool:
    """The reference loop's rule for drawing train batches from the
    dataplane: the config asks for it and the dataset's intrinsics are one
    shared [3, 3] matrix."""
    pixtocams = getattr(dataset, "pixtocams", None)
    return bool(config.use_native_batcher) and pixtocams is not None and pixtocams.ndim == 2


def _ptr(a):
    if a is None:
        return ctypes.POINTER(ctypes.c_float)()
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRayBatcher:
    """Host-cast train batches of a ray dataset from the C++ dataplane.

    Needs shared [3, 3] intrinsics. `sample_batch` draws `dataset.batch_size`
    rays: ones for `lossmult`, the dataset's `near` and `far`, a zero
    `imageplane`, `cam_idx` [n, 1] int32, and no `depth_gt` / `depth_sup`
    where the dataset has none.
    """

    def __init__(self, dataset, seed: int = 0, num_threads: int = 0):
        if dataset.pixtocams.ndim != 2:
            raise ValueError("native batcher needs shared intrinsics [3,3]")
        self._lib = load()
        self._ds = dataset
        self._seed = (seed + 1) % 2**64
        self._threads = num_threads
        f32 = lambda a: None if a is None else np.ascontiguousarray(a, np.float32)
        self._images = f32(dataset.images)
        self._depth_gt = f32(dataset.depth_gt)
        self._depth_sup = f32(dataset.depth_sup)
        self._pixtocams = f32(dataset.pixtocams)
        self._camtoworlds = f32(dataset.camtoworlds)

    def sample_batch(self) -> rays_lib.Batch:
        n = self._ds.batch_size
        f32 = np.float32
        rgb = np.empty((n, 3), f32)
        depth_gt = np.empty((n,), f32)
        depth_sup = np.empty((n,), f32)
        origins = np.empty((n, 3), f32)
        directions = np.empty((n, 3), f32)
        viewdirs = np.empty((n, 3), f32)
        radii = np.empty((n, 1), f32)
        cam_idx = np.empty((n,), np.int32)
        # The reference's 64-bit LCG step before every call.
        self._seed = (self._seed * 6364136223846793005 + 1442695040888963407) % 2**64
        self._lib.sample_ray_batch(
            _ptr(self._images), _ptr(self._depth_gt), _ptr(self._depth_sup),
            _ptr(self._pixtocams), _ptr(self._camtoworlds),
            self._ds.n_images, self._ds.height, self._ds.width, n,
            ctypes.c_uint64(self._seed), self._threads,
            _ptr(rgb), _ptr(depth_gt), _ptr(depth_sup),
            _ptr(origins), _ptr(directions), _ptr(viewdirs), _ptr(radii),
            cam_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        t = torch.from_numpy
        rays = rays_lib.Rays(
            origins=t(origins),
            directions=t(directions),
            viewdirs=t(viewdirs),
            radii=t(radii),
            imageplane=torch.zeros((n, 2)),
            lossmult=torch.ones((n, 1)),
            near=torch.full((n, 1), self._ds.near, dtype=torch.float32),
            far=torch.full((n, 1), self._ds.far, dtype=torch.float32),
            cam_idx=t(cam_idx[:, None].copy()),
        )
        return rays_lib.Batch(
            rays=rays,
            rgb=t(rgb),
            depth_gt=None if self._depth_gt is None else t(depth_gt),
            depth_sup=None if self._depth_sup is None else t(depth_sup),
        )
