"""Reflection directions and integrated directional encodings (Ref-NeRF).

Port of the reference package's `ops/refdirs.py`: vector reflection, the
weighted mean angular error, and the integrated directional encoding (IDE),
spherical harmonics attenuated by a von Mises-Fisher roughness (Eqs. 6-8 of
arxiv.org/abs/2112.03907).

The spherical-harmonic coefficient table is built once in numpy; the
encoding is real polynomials: (x + iy)^m by a real recurrence, and the
z-polynomials as the Vandermonde of z times the coefficient table. That
product is summed term by term in float32, so no TensorFloat-32 matmul can
round it (its high-degree terms cancel to a few digits).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def l2_normalize(x: torch.Tensor, eps: float = _F32_EPS) -> torch.Tensor:
    """x / |x|, with |x|^2 floored at `eps`."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=eps))


def reflect(viewdirs: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Reflect view directions about unit normals: 2(n.v)n - v."""
    return 2.0 * torch.sum(normals * viewdirs, dim=-1, keepdim=True) * normals - viewdirs


def weighted_mae_degrees(weights, normals, normals_gt) -> torch.Tensor:
    """Weighted mean angular error between unit normal fields, in degrees."""
    one = 1.0 - _F32_EPS
    cos = torch.clamp(torch.sum(normals * normals_gt, dim=-1), -one, one)
    return (weights * torch.arccos(cos)).sum() / weights.sum() * 180.0 / math.pi


@functools.lru_cache(maxsize=None)
def _ide_tables(deg_view: int):
    """(ml_array [2, M] of rows (m, l), coefficient matrix [l_max + 1, M])."""
    if deg_view > 5:
        raise ValueError("IDE is numerically unstable beyond degree 5")
    ml = []
    for i in range(deg_view):
        l = 2**i
        ml.extend((m, l) for m in range(l + 1))
    ml_array = np.array(ml).T
    l_max = 2 ** (deg_view - 1)

    def binom(a, k):
        return np.prod(a - np.arange(k)) / math.factorial(k)

    def legendre_coeff(l, m, k):
        return ((-1) ** m * 2**l * math.factorial(l) / math.factorial(k)
                / math.factorial(l - k - m) * binom(0.5 * (l + k + m - 1.0), l))

    mat = np.zeros((l_max + 1, ml_array.shape[1]))
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat[k, i] = (
                np.sqrt((2 * l + 1) * math.factorial(l - m) / (4 * np.pi * math.factorial(l + m)))
                * legendre_coeff(l, m, k)
            )
    return ml_array, mat


def generate_ide_fn(deg_view: int):
    """Returns ide(xyz [..., 3], kappa_inv [..., 1]) -> [..., 2M]: the real
    parts of the M (m, l) harmonics, then their imaginary parts."""
    ml_array, mat = _ide_tables(deg_view)
    m_idx = torch.from_numpy(ml_array[0].astype(np.int64))
    l_vals = torch.from_numpy(ml_array[1].astype(np.float32))
    mat32 = torch.from_numpy(mat.astype(np.float32))
    max_m = int(ml_array[0].max())

    def ide(xyz: torch.Tensor, kappa_inv: torch.Tensor) -> torch.Tensor:
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        coeffs = mat32.to(xyz.device)
        # The z-polynomials: sum_k z^k mat[k], a term at a time in float32.
        z_pow = torch.ones_like(z)
        poly = z_pow * coeffs[0]
        for k in range(1, coeffs.shape[0]):
            z_pow = z_pow * z
            poly = poly + z_pow * coeffs[k]

        # (x + i y)^m by the real recurrence from re_0 = 1, im_0 = 0.
        res, ims = [torch.ones_like(x)], [torch.zeros_like(x)]
        for _ in range(max_m):
            re, im = res[-1], ims[-1]
            res.append(re * x - im * y)
            ims.append(re * y + im * x)
        idx = m_idx.to(xyz.device)
        re_m = torch.cat(res, dim=-1)[..., idx]
        im_m = torch.cat(ims, dim=-1)[..., idx]

        l = l_vals.to(xyz.device)
        atten = torch.exp(-(0.5 * l * (l + 1.0)) * kappa_inv)
        return torch.cat([re_m * poly * atten, im_m * poly * atten], dim=-1)

    return ide


def generate_dir_enc_fn(deg_view: int):
    """The plain (zero-roughness) directional spherical-harmonic encoding."""
    ide = generate_ide_fn(deg_view)

    def enc(xyz: torch.Tensor) -> torch.Tensor:
        return ide(xyz, torch.zeros_like(xyz[..., :1]))

    return enc
