"""Photometric, depth-supervision and proposal/distortion losses.

Port of the reference package's `train/losses.py`: rgb (mse, charb and
rawnerf's relative loss for linear HDR data), the five depth-loss families
(expected-depth mse and l1, DS-NeRF KL, Urban Radiance Fields and Gaussian
NLL) and their dispatch on interval ('tdist') and point-sample
('steps'/'lengths') histories, the interlevel regularizer, the distortion
regularizer on interval histories (mip-NeRF 360) and on point samples
(Instant-NGP), the Ref-NeRF orientation and predicted-normal regularizers,
NGP's opacity entropy and NeRF++'s autoexposure regularizer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from outdoor_nerf_depth_torch.ops import mathx, stepfuns

URF_SIGMA_SCALE = 3.0


def rgb_loss(pred, target, lossmult=None, kind: str = "mse", charb_padding=0.001):
    """Per-level photometric loss, lossmult-weighted mean. Returns (loss, mse)."""
    resid_sq = (pred - target) ** 2
    lossmult = torch.ones_like(resid_sq) if lossmult is None else lossmult.expand(resid_sq.shape)
    denom = torch.clamp(lossmult.sum(), min=1e-8)
    mse = (lossmult * resid_sq).sum() / denom
    if kind == "mse":
        per_elem = resid_sq
    elif kind == "charb":
        per_elem = torch.sqrt(resid_sq + charb_padding**2)
    elif kind == "rawnerf":
        # min(1, pred), whose gradient splits in half where pred is exactly 1
        # (rgb_padding lets it get there), as the reference's does; `clamp`
        # would give it all to pred.
        clipped = torch.minimum(pred, torch.ones_like(pred))
        grad_scale = 1.0 / (1e-3 + clipped.detach())
        per_elem = (clipped - target) ** 2 * grad_scale**2
    else:
        raise ValueError(f"unknown rgb loss {kind!r}")
    return (lossmult * per_elem).sum() / denom, mse


def expected_depth_loss(depth_pred, depth_sup, kind: str = "mse", reduce: str = "mean_all"):
    """MSE/L1 between expected termination depth and the prior (<=0 invalid)."""
    mask = (depth_sup > 0).to(depth_pred.dtype)
    resid = mask * depth_pred - mask * depth_sup
    per_ray = resid**2 if kind == "mse" else resid.abs()
    if reduce == "mean_all":
        return per_ray.mean()
    if reduce == "mean_valid":
        return per_ray.sum() / torch.clamp(mask.sum(), min=1.0)
    raise ValueError(f"unknown reduce {reduce!r}")


def ds_nerf_kl_loss(weights, depth_sup, steps, lengths, sigma,
                    fg_far: Optional[torch.Tensor] = None, eps: float = 1e-7):
    """DS-NeRF depth loss: -log(w) windowed around the supervised depth."""
    mask = depth_sup > 0
    if fg_far is not None:
        mask = mask & (depth_sup < fg_far)
    window = torch.exp(-((steps - depth_sup[..., None]) ** 2) / (2.0 * sigma))
    per_ray = torch.sum(-torch.log(weights + eps) * window * lengths, dim=-1)
    return torch.mean(per_ray * mask)


def gaussian_nll_depth_loss(depth_pred, steps, weights, depth_sup, depth_sup_std,
                            eps: float = 1e-3):
    """Gaussian NLL of the render's termination distribution against the
    measured depth (mean `depth_sup` <= 0 invalid, std `depth_sup_std`,
    scalar or per ray), on the rays whose prediction falls outside the
    measurement: |mean difference| > std, or predicted variance > std^2.
    Masked-sum form: the sum over those rays divided by all rays."""
    valid = depth_sup > 0
    pred_var = torch.sum((steps - depth_pred[..., None]) ** 2 * weights, dim=-1) + 1e-5
    std = torch.broadcast_to(torch.as_tensor(depth_sup_std, dtype=depth_sup.dtype,
                                             device=depth_sup.device), depth_sup.shape)
    outside = (torch.abs(depth_pred - depth_sup) - std > 0.0) | (std**2 < pred_var)
    apply = valid & outside
    var = torch.clamp(pred_var, min=eps)
    nll = 0.5 * (torch.log(var) + (depth_pred - depth_sup) ** 2 / var)
    return torch.sum(apply * nll) / depth_sup.numel()


def urban_rf_depth_loss(weights, depth_sup, depth_pred, steps, sigma):
    """Urban Radiance Fields LiDAR loss: L2 + near/empty line-of-sight terms."""
    mask = (depth_sup > 0).to(weights.dtype)
    l2 = (depth_sup - depth_pred) ** 2
    scale = sigma / URF_SIGMA_SCALE
    d = depth_sup[..., None]
    log_prob = (-((steps - d) ** 2) / (2.0 * scale**2) - math.log(scale)
                - 0.5 * math.log(2.0 * math.pi))
    near_mask = (steps <= d + sigma) & (steps >= d - sigma)
    near = torch.sum(near_mask * (weights - torch.exp(log_prob)) ** 2, dim=-1)
    empty = torch.sum((steps < d - sigma) * weights**2, dim=-1)
    return torch.mean((l2 + near + empty) * mask)


def depth_loss_from_history(level_history: dict, depth_sup, depth_pred, dirs, sigma,
                            kind: str, reduce: str = "mean_all", fg_far_mask: bool = False):
    """Dispatch a depth loss given one level's ray history ('tdist' edges or
    'steps'/'lengths' points). `sigma` is the scene-scaled variance knob:
    kl's window variance, urf's line-of-sight half-width (3 of its std) and,
    through its square root, nll's measurement std. Only kl drops rays
    beyond NeRF++'s `fg_far`."""
    if kind in ("mse", "l1"):
        return expected_depth_loss(depth_pred, depth_sup, kind=kind, reduce=reduce)
    weights = level_history["weights"]
    if "tdist" in level_history:
        tdist = level_history["tdist"]
        steps = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
        lengths = torch.diff(tdist, dim=-1) * torch.linalg.norm(dirs[..., None, :], dim=-1)
    else:  # point samples
        steps, lengths = level_history["steps"], level_history["lengths"]
    fg_far = level_history.get("fg_far") if fg_far_mask else None
    if kind == "kl":
        return ds_nerf_kl_loss(weights, depth_sup, steps, lengths, sigma, fg_far)
    if kind == "urf":
        return urban_rf_depth_loss(weights, depth_sup, depth_pred, steps, sigma)
    if kind == "nll":
        return gaussian_nll_depth_loss(depth_pred, steps, weights, depth_sup, math.sqrt(sigma))
    raise ValueError(f"unknown depth loss {kind!r}")


def interlevel_loss(ray_history) -> torch.Tensor:
    """Proposal supervision: each prop histogram upper-bounds the nerf one.

    Gradients flow only into the proposal levels (nerf side detached).
    """
    t = ray_history[-1]["sdist"].detach()
    w = ray_history[-1]["weights"].detach()
    total = 0.0
    for level in ray_history[:-1]:
        total = total + torch.mean(
            stepfuns.outer_envelope_loss(t, w, level["sdist"], level["weights"])
        )
    return total


def distortion_loss(ray_history) -> torch.Tensor:
    """Distortion on the final level.

    Interval histories ('sdist') use the mip-NeRF 360 form in normalized
    s-space; point samples ('steps', 'lengths') the same functional in
    metric t (the DVGO-v2 form), which builds [..., K, K] pairwise terms.
    """
    last = ray_history[-1]
    if "sdist" in last:
        return torch.mean(stepfuns.distortion_loss(last["sdist"], last["weights"]))
    w, t, dt = last["weights"], last["steps"], last["lengths"]
    pair = torch.abs(t[..., :, None] - t[..., None, :])
    inter = torch.sum(w * torch.sum(w[..., None, :] * pair, dim=-1), dim=-1)
    intra = torch.sum(w**2 * dt, dim=-1) / 3.0
    return torch.mean(inter + intra)


def orientation_loss(ray_history, viewdirs, coarse_mult, final_mult,
                     target: str = "normals_pred") -> torch.Tensor:
    """Ref-NeRF orientation regularizer: the weight-weighted squared part of
    n.(-v) below zero, so normals facing away from the camera cost; every
    level of the history must hold `target`."""
    total = 0.0
    v = -viewdirs
    for i, level in enumerate(ray_history):
        n = level.get(target)
        if n is None:
            raise ValueError(f"orientation loss needs {target!r} in history")
        n_dot_v = torch.sum(n * v[..., None, :], dim=-1)
        per_ray = torch.sum(level["weights"] * torch.clamp(n_dot_v, max=0.0) ** 2, dim=-1)
        mult = final_mult if i == len(ray_history) - 1 else coarse_mult
        total = total + mult * torch.mean(per_ray)
    return total


def predicted_normal_loss(ray_history, coarse_mult, final_mult) -> torch.Tensor:
    """Tie predicted normals to density-gradient normals (Ref-NeRF): the
    weight-weighted 1 - n.n_pred; every level must hold both."""
    total = 0.0
    for i, level in enumerate(ray_history):
        n, n_pred = level.get("normals"), level.get("normals_pred")
        if n is None or n_pred is None:
            raise ValueError("predicted-normal loss needs both normal fields")
        per_ray = torch.sum(level["weights"] * (1.0 - torch.sum(n * n_pred, dim=-1)), dim=-1)
        mult = final_mult if i == len(ray_history) - 1 else coarse_mult
        total = total + mult * torch.mean(per_ray)
    return total


def opacity_entropy_loss(acc, eps: float = 1e-5) -> torch.Tensor:
    """NGP's opacity regularizer: -o log o pushes each ray to 0 or 1."""
    o = torch.clamp(acc, eps, 1.0 - eps)
    return torch.mean(-o * torch.log(o))


def autoexposure_reg(scale, shift) -> torch.Tensor:
    """Keep the learned per-image exposure near identity: |scale - 1| + |shift|."""
    return torch.mean(mathx.abs_(scale - 1.0)) + torch.mean(mathx.abs_(shift))
