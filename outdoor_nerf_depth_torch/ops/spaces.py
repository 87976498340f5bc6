"""Coordinate spaces, ray-distance warps, and frequency encodings.

Port of the reference package's `ops/spaces.py`. The reference pushes a
Gaussian through a warp by linearizing the warp with automatic
differentiation; here the scene contraction carries its Jacobian in closed
form, and `track_gaussian` applies it as J cov J^T.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from outdoor_nerf_depth_torch.ops import mathx

_EPS = torch.finfo(torch.float32).eps


def contract(x: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 scene contraction (Eq. 10 of arxiv.org/abs/2111.12077)."""
    r_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=_EPS)
    scale = (2.0 * torch.sqrt(r_sq) - 1.0) / r_sq
    return torch.where(r_sq <= 1.0, x, scale * x)


def contract_jacobian(x: torch.Tensor) -> torch.Tensor:
    """d contract(x) / dx, [..., 3, 3].

    Identity inside the unit ball. Outside, contract(x) = s(r) x with
    s = (2r - 1) / r^2, so J = s I + s'(r) / r * x x^T and s'(r) / r =
    2 (1 - r) / r^4.
    """
    r_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=_EPS)
    r = torch.sqrt(r_sq)
    scale = (2.0 * r - 1.0) / r_sq
    radial = 2.0 * (1.0 - r) / (r_sq * r_sq)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    jac = scale[..., None] * eye + radial[..., None] * (x[..., :, None] * x[..., None, :])
    return torch.where((r_sq <= 1.0)[..., None], eye.expand(jac.shape), jac)


_JACOBIANS = {contract: contract_jacobian}


def track_gaussian(fn, mean: torch.Tensor, cov: torch.Tensor):
    """Push a Gaussian (mean, full cov) through `fn` by linearization.

    `fn` must have a closed-form Jacobian registered here (`contract`).
    Returns (fn(mean), J cov J^T).
    """
    if mean.ndim + 1 != cov.ndim:
        raise ValueError(
            f"expected full covariance with one extra dim, got mean "
            f"{tuple(mean.shape)} cov {tuple(cov.shape)}"
        )
    if fn not in _JACOBIANS:
        raise ValueError(f"no closed-form Jacobian for {fn!r}")
    jac = _JACOBIANS[fn](mean)
    return fn(mean), jac @ cov @ jac.transpose(-1, -2)


_WARPS = {
    "reciprocal": (torch.reciprocal, torch.reciprocal),
    "log": (torch.log, torch.exp),
    "exp": (torch.exp, torch.log),
    "sqrt": (torch.sqrt, torch.square),
    "square": (torch.square, torch.sqrt),
}


def metric_to_normalized(warp, t_near, t_far):
    """Bijection between metric distance t and normalized distance s in [0,1].

    `warp` is None (linear), 'piecewise', or a name from {reciprocal, log,
    exp, sqrt, square}. Returns (t_to_s, s_to_t).
    """
    if warp is None:
        fwd = inv = lambda x: x
    elif warp == "piecewise":
        fwd = lambda x: torch.where(x < 1.0, 0.5 * x, 1.0 - 0.5 / x)
        inv = lambda x: torch.where(x < 0.5, 2.0 * x, 0.5 / (1.0 - x))
    else:
        if warp not in _WARPS:
            raise ValueError(f"unknown ray-distance warp {warp!r}")
        fwd, inv = _WARPS[warp]

    s_near, s_far = fwd(t_near), fwd(t_far)
    t_to_s = lambda t: (fwd(t) - s_near) / (s_far - s_near)
    s_to_t = lambda s: inv(s * s_far + (1.0 - s) * s_near)
    return t_to_s, s_to_t


def expected_sin(mean, var):
    """E[sin(x)] for x ~ N(mean, var): exp(-var/2) sin(mean)."""
    return torch.exp(-0.5 * var) * mathx.safe_sin(mean)


def _scales(min_deg: int, max_deg: int, like: torch.Tensor):
    return 2.0 ** torch.arange(min_deg, max_deg, dtype=like.dtype, device=like.device)


def integrated_pos_enc(mean, var, min_deg: int, max_deg: int):
    """Integrated positional encoding of a diagonal Gaussian.

    Output [..., 2 * d * n_freqs], ordered (all sin scales, all cos scales)
    with per-scale dims contiguous.
    """
    scales = _scales(min_deg, max_deg, mean)
    out_shape = mean.shape[:-1] + (-1,)
    mean_s = (mean[..., None, :] * scales[:, None]).reshape(out_shape)
    var_s = (var[..., None, :] * scales[:, None] ** 2).reshape(out_shape)
    phases = torch.cat([mean_s, mean_s + 0.5 * math.pi], dim=-1)
    return expected_sin(phases, torch.cat([var_s, var_s], dim=-1))


def pos_enc(x, min_deg: int, max_deg: int, append_identity: bool = True):
    """Classic NeRF sinusoidal positional encoding at frequencies 2^deg."""
    scales = _scales(min_deg, max_deg, x)
    xs = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    feat = torch.sin(torch.cat([xs, xs + 0.5 * math.pi], dim=-1))
    if append_identity:
        return torch.cat([x, feat], dim=-1)
    return feat


def project_and_diagonalize(mean, cov, basis):
    """Project a full-cov Gaussian onto `basis` columns; keep only marginals."""
    mean_p = mean @ basis
    var_p = torch.sum(basis * (cov @ basis), dim=-2)
    return mean_p, var_p


@functools.lru_cache(maxsize=None)
def _unit_sphere_tesselation(base_shape: str, subdivisions: int) -> np.ndarray:
    if base_shape == "icosahedron":
        phi = (np.sqrt(5.0) + 1.0) / 2.0
        verts = np.array(
            [
                (-1, 0, phi), (1, 0, phi), (-1, 0, -phi), (1, 0, -phi),
                (0, phi, 1), (0, phi, -1), (0, -phi, 1), (0, -phi, -1),
                (phi, 1, 0), (-phi, 1, 0), (phi, -1, 0), (-phi, -1, 0),
            ],
            dtype=np.float64,
        ) / np.sqrt(phi + 2.0)
        faces = np.array(
            [
                (0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
                (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
                (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
                (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11),
            ]
        )
    elif base_shape == "octahedron":
        verts = np.array(
            [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)],
            dtype=np.float64,
        )
        # Faces = vertex triples adjacent to each cube corner.
        corners = np.array(list(itertools.product([-1, 1], repeat=3)))
        d = (
            np.sum(corners**2, 1)[:, None]
            + np.sum(verts**2, 1)[None, :]
            - 2 * corners @ verts.T
        )
        pairs = np.argwhere(np.isclose(d, 2.0))
        faces = np.sort(pairs[:, 1].reshape(3, -1).T, axis=1)
    else:
        raise ValueError(f"unknown base_shape {base_shape!r}")

    # Barycentric tesselation of each face, reprojected to the sphere.
    v = subdivisions
    bary = np.array(
        [(i, j, v - i - j) for i in range(v + 1) for j in range(v + 1 - i)],
        dtype=np.float64,
    ) / v
    pts = np.concatenate([bary @ verts[f] for f in faces], axis=0)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)

    # Deduplicate coincident vertices (first occurrence wins, preserving order).
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, -1)
    first = np.array([np.argwhere(row <= 1e-4).min() for row in d2])
    return pts[np.unique(first)]


def sphere_basis(
    base_shape: str = "icosahedron",
    subdivisions: int = 2,
    remove_symmetries: bool = True,
) -> torch.Tensor:
    """Geodesic-polyhedron direction basis, [3, m] float32 on the CPU."""
    verts = _unit_sphere_tesselation(base_shape, subdivisions)
    if remove_symmetries:
        d2 = np.sum((verts[:, None, :] + verts[None, :, :]) ** 2, -1)
        keep = np.any(np.triu(d2 < 1e-4), axis=1)
        verts = verts[keep]
    return torch.tensor(verts[:, ::-1].T.copy(), dtype=torch.float32)
