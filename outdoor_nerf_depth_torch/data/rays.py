"""Ray/pixel/batch dataclasses of tensors.

Port of the reference package's `data/rays.py`. Every field keeps a trailing
feature axis (3 for vectors, 1 for scalars), so every leaf shares the leading
ray axes. `map_fields` applies a function to every tensor of a (nested)
dataclass, which is how batches move to a device, get flattened or chunked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class Pixels:
    """Integer pixel coordinates plus per-ray metadata, before ray casting."""

    pix_x: Any
    pix_y: Any
    cam_idx: Any
    lossmult: Any
    near: Any
    far: Any
    exposure_idx: Optional[Any] = None
    exposure_values: Optional[Any] = None


@dataclasses.dataclass
class Rays:
    """World-space rays with cone footprints and per-ray bounds."""

    origins: Any  # [..., 3]
    directions: Any  # [..., 3] un-normalized (metric deltas scale by |d|)
    viewdirs: Any  # [..., 3] unit
    radii: Any  # [..., 1] cone base radius at unit distance
    imageplane: Any  # [..., 2]
    lossmult: Any  # [..., 1]
    near: Any  # [..., 1]
    far: Any  # [..., 1]
    cam_idx: Any  # [..., 1] int32
    exposure_idx: Optional[Any] = None
    exposure_values: Optional[Any] = None


@dataclasses.dataclass
class Batch:
    """One training/eval unit: rays (or pixels) plus per-ray supervision."""

    rays: Any  # Rays | Pixels
    rgb: Optional[Any] = None  # [..., 3]
    depth_gt: Optional[Any] = None  # [...]
    depth_sup: Optional[Any] = None  # [...] supervision prior (<=0 invalid)
    normals: Optional[Any] = None
    alphas: Optional[Any] = None


def map_fields(fn: Callable, obj):
    """Apply `fn` to every non-None leaf of a (nested) ray dataclass."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{f.name: map_fields(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)},
        )
    return None if obj is None else fn(obj)


def leaves(obj):
    """The non-None leaves of a (nested) ray dataclass, in field order."""
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) for x in leaves(getattr(obj, f.name))]
    return [] if obj is None else [obj]


def to_device(obj, device, non_blocking: bool = False):
    """Every tensor of a (nested) ray dataclass moved to `device`."""
    return map_fields(lambda x: x.to(device, non_blocking=non_blocking), obj)


def dummy_rays(batch_shape=(10,), device=None) -> Rays:
    """Minimal valid Rays for shape checks."""
    vec = lambda n: torch.zeros(batch_shape + (n,), dtype=torch.float32, device=device)
    z = torch.tensor([0.0, 0.0, 1.0], device=device)
    return Rays(
        origins=vec(3),
        directions=vec(3) + z,
        viewdirs=vec(3) + z,
        radii=vec(1) + 1e-3,
        imageplane=vec(2),
        lossmult=vec(1) + 1.0,
        near=vec(1) + 0.1,
        far=vec(1) + 100.0,
        cam_idx=torch.zeros(batch_shape + (1,), dtype=torch.int32, device=device),
    )


def pad_to_multiple(obj, multiple: int, axis: int = 0):
    """Edge-pad every tensor so dim `axis` divides `multiple`; returns (obj, pad)."""
    n = leaves(obj)[0].shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return obj, 0

    def _pad(x):
        edge = x.narrow(axis, x.shape[axis] - 1, 1)
        reps = [1] * x.dim()
        reps[axis] = pad
        return torch.cat([x, edge.repeat(reps)], dim=axis)

    return map_fields(_pad, obj), pad
