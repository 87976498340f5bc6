"""Ray/sphere geometry of the inverted-sphere (NeRF++) parametrization.

Port of the reference package's `ops/geometry.py`: the exit distance of a
ray from the unit sphere, and the background point where a ray crosses the
sphere of radius 1/inv_r. Nothing raises on bad inputs: grazing rays and
inverse radii at 0 are clamped to finite values, as in the reference.
"""

from __future__ import annotations

import torch

_TINY = 1e-6


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _safe_asin(x: torch.Tensor) -> torch.Tensor:
    # |p_mid| can graze 1.0 from roundoff.
    return torch.asin(torch.clamp(x, -1.0 + _TINY, 1.0 - _TINY))


def intersect_unit_sphere(ray_o: torch.Tensor, ray_d: torch.Tensor):
    """Distance along each ray to its exit from the unit sphere.

    Origins are assumed inside the sphere. Returns (t_exit, valid): `valid`
    flags rays whose closest point to the centre lies inside the sphere;
    the others get a clamped, finite t_exit.
    """
    d_dot = torch.sum(ray_d * ray_d, dim=-1)
    t_mid = -torch.sum(ray_d * ray_o, dim=-1) / d_dot
    p_mid = ray_o + t_mid[..., None] * ray_d
    p_sq = torch.sum(p_mid * p_mid, dim=-1)
    half_chord = torch.sqrt(torch.clamp(1.0 - p_sq, min=0.0)) / torch.sqrt(d_dot)
    return t_mid + half_chord, p_sq < 1.0


def inverted_sphere_points(ray_o: torch.Tensor, ray_d: torch.Tensor, inv_r: torch.Tensor):
    """The background point at radius 1/inv_r on each ray, inv_r in (0, 1].

    Rotates the unit-sphere exit point within the ray's plane (Rodrigues'
    formula) onto the sphere of radius 1/inv_r. Returns (pts [..., 4], the
    unit direction of that point and inv_r; t_metric [...], the distance
    along the ray to it, for the background's expected depth).
    """
    d_dot = torch.sum(ray_d * ray_d, dim=-1)
    t_mid = -torch.sum(ray_d * ray_o, dim=-1) / d_dot
    p_mid = ray_o + t_mid[..., None] * ray_d
    p_mid_r = _norm(p_mid)
    inv_d_norm = 1.0 / torch.sqrt(d_dot)

    half_chord = torch.sqrt(torch.clamp(1.0 - p_mid_r**2, min=0.0)) * inv_d_norm
    p_exit = ray_o + (t_mid + half_chord)[..., None] * ray_d

    # Rotate p_exit from angle asin(|p_mid|) down to asin(|p_mid| * inv_r).
    axis = torch.linalg.cross(ray_o, p_exit, dim=-1)
    axis = axis / torch.clamp(_norm(axis, keepdim=True), min=_TINY)
    angle = (_safe_asin(p_mid_r) - _safe_asin(p_mid_r * inv_r))[..., None]

    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    rotated = (
        p_exit * cos_a
        + torch.linalg.cross(axis, p_exit, dim=-1) * sin_a
        + axis * torch.sum(axis * p_exit, dim=-1, keepdim=True) * (1.0 - cos_a)
    )
    rotated = rotated / torch.clamp(_norm(rotated, keepdim=True), min=_TINY)
    pts = torch.cat([rotated, inv_r[..., None]], dim=-1)

    theta = _safe_asin(p_mid_r * inv_r)
    t_metric = torch.cos(theta) * inv_d_norm / torch.clamp(inv_r, min=_TINY) + t_mid
    return pts, t_metric
