"""Differentiable volume rendering: frustum Gaussians, alpha compositing.

Port of the reference package's `ops/volren.py`. The compositing weights go
through `ops.volren_weights` (CUDA kernels K1a/K1b on the GPU).
"""

from __future__ import annotations

import torch

from outdoor_nerf_depth_torch.ops import stepfuns, volren_weights

_EPS = torch.finfo(torch.float32).eps


def gaussianize_cone(d, t0, t1, base_radius):
    """Moment-match a conical frustum with a Gaussian (mip-NeRF Eq. 7).

    Returns (t_mean, t_var, r_var): the 1D marginal along the axis plus the
    isotropic perpendicular variance, before lifting to 3D.
    """
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    denom = torch.clamp(3.0 * mu**2 + hw**2, min=_EPS)
    t_mean = mu + (2.0 * mu * hw**2) / denom
    t_var = hw**2 / 3.0 - (4.0 / 15.0) * hw**4 * (12.0 * mu**2 - hw**2) / denom**2
    r_var = base_radius**2 * (mu**2 / 4.0 + (5.0 / 12.0) * hw**2 - (4.0 / 15.0) * hw**4 / denom)
    return t_mean, t_var, r_var


def gaussianize_cylinder(d, t0, t1, radius):
    """Moment-match a cylindrical segment with a Gaussian (see gaussianize_cone);
    the moments do not depend on the direction `d`."""
    del d
    t_mean = 0.5 * (t0 + t1)
    t_var = (t1 - t0) ** 2 / 12.0
    r_var = radius**2 / 4.0
    return t_mean, t_var, r_var


def lift_to_3d(d, t_mean, t_var, r_var, diagonal: bool):
    """Lift axis/perpendicular moments to 3D: cov = t_var dd^T + r_var (I - dd^T/|d|^2)."""
    mean = d[..., None, :] * t_mean[..., None]
    d_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    if diagonal:
        axis = d**2
        perp = 1.0 - axis / d_sq
        cov = t_var[..., None] * axis[..., None, :] + r_var[..., None] * perp[..., None, :]
    else:
        outer = d[..., :, None] * d[..., None, :]
        eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
        perp = eye - d[..., :, None] * (d / d_sq)[..., None, :]
        cov = (
            t_var[..., None, None] * outer[..., None, :, :]
            + r_var[..., None, None] * perp[..., None, :, :]
        )
    return mean, cov


def cast_rays(tdist, origins, directions, radii, ray_shape="cone", diagonal=True):
    """Featurize ray intervals as 3D Gaussians (cone frusta or cylinder
    segments): means [..., n, 3], covs."""
    if ray_shape == "cone":
        gaussianize = gaussianize_cone
    elif ray_shape == "cylinder":
        gaussianize = gaussianize_cylinder
    else:
        raise ValueError(f"ray_shape must be cone|cylinder, got {ray_shape!r}")
    moments = gaussianize(directions, tdist[..., :-1], tdist[..., 1:], radii)
    mean, cov = lift_to_3d(directions, *moments, diagonal=diagonal)
    return mean + origins[..., None, :], cov


def optical_depth(density, tdist, dirs, opaque_background=False):
    """Metric optical depth per interval: tau_i = density_i * |interval_i| * |dirs|."""
    metric_delta = torch.diff(tdist, dim=-1) * torch.linalg.norm(dirs[..., None, :], dim=-1)
    tau = density * metric_delta
    if opaque_background:
        tau = torch.cat([tau[..., :-1], torch.full_like(tau[..., -1:], float("inf"))], dim=-1)
    return tau


def weights_from_optical_depth(tau):
    """Compositing weights w_i = T_i * (1 - exp(-tau_i)) (kernel K1 on the GPU)."""
    return volren_weights.weights_from_tau(tau)


def composite_weights(density, tdist, dirs, opaque_background=False):
    """Weights from densities on the intervals of `tdist`."""
    return weights_from_optical_depth(optical_depth(density, tdist, dirs, opaque_background))


def alpha_composite_weights(density, tdist, dirs, opaque_background=False):
    """Returns (weights, alpha, transmittance) from densities on `tdist`."""
    tau = optical_depth(density, tdist, dirs, opaque_background)
    alpha = 1.0 - torch.exp(-tau)
    trans = torch.exp(
        -torch.cat([torch.zeros_like(tau[..., :1]), torch.cumsum(tau[..., :-1], dim=-1)], dim=-1)
    )
    return alpha * trans, alpha, trans


def composite(
    rgbs,
    weights,
    tdist,
    bg_rgbs,
    t_far,
    compute_extras: bool,
    extras=None,
    percentiles=(5, 50, 95),
):
    """Alpha-composite per-sample quantities into per-ray outputs.

    Always emits 'rgb' (background-filled). With `compute_extras` also 'acc',
    each entry of `extras` ([..., S, C] per sample, such as normals or
    roughness; None entries skipped) summed by weight, 'distance_mean'
    (log-space expected termination
    distance), 'depth' (expected t-mid) and 'distance_{percentile_5,median,
    percentile_95}'.
    """
    out = {}
    acc = weights.sum(dim=-1)
    bg_weight = torch.clamp(1.0 - acc[..., None], min=0.0)
    out["rgb"] = torch.sum(weights[..., None] * rgbs, dim=-2) + bg_weight * bg_rgbs

    if not compute_extras:
        return out

    out["acc"] = acc
    for key, val in (extras or {}).items():
        if val is not None:
            out[key] = torch.sum(weights[..., None] * val, dim=-2)
    t_mid = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    t_lo, t_hi = tdist[..., 0], tdist[..., -1]
    mean_log = torch.sum(weights * torch.log(t_mid), dim=-1) / torch.clamp(acc, min=_EPS)
    inf = float("inf")
    out["distance_mean"] = torch.clip(
        torch.nan_to_num(torch.exp(mean_log), nan=inf), t_lo, t_hi
    )
    out["depth"] = torch.clip(
        torch.nan_to_num(torch.sum(weights * t_mid, dim=-1), nan=inf), t_lo, t_hi
    )

    # Percentiles over the weights augmented with the background mass at
    # t_far, so the histogram integrates to exactly 1.
    t_aug = torch.cat([tdist, t_far], dim=-1)
    w_aug = torch.cat([weights, bg_weight], dim=-1)
    pcts = stepfuns.weighted_percentile(t_aug, w_aug, percentiles)
    for i, p in enumerate(percentiles):
        name = "distance_median" if p == 50 else f"distance_percentile_{p}"
        out[name] = pcts[..., i]
    return out
