"""Photometric, depth-supervision and proposal/distortion losses.

Port of the mip-NeRF path of the reference package's `train/losses.py`:
rgb (mse, charb), expected-depth (mse, l1) and DS-NeRF KL depth losses, and
the interlevel and distortion regularizers on interval histories. The URF
and Gaussian-NLL depth losses and the Ref-NeRF/NGP regularizers are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from outdoor_nerf_depth_torch.ops import stepfuns


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
    else:
        raise ValueError(f"unknown or unported rgb loss {kind!r}")
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


def depth_loss_from_history(level_history: dict, depth_sup, depth_pred, dirs, sigma,
                            kind: str, reduce: str = "mean_all", fg_far_mask: bool = False):
    """Dispatch a depth loss given one level's ray history ('tdist' edges)."""
    if kind in ("mse", "l1"):
        return expected_depth_loss(depth_pred, depth_sup, kind=kind, reduce=reduce)
    if kind != "kl":
        raise NotImplementedError(f"depth loss {kind!r} is not ported yet")
    tdist = level_history["tdist"]
    steps = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    lengths = torch.diff(tdist, dim=-1) * torch.linalg.norm(dirs[..., None, :], dim=-1)
    fg_far = level_history.get("fg_far") if fg_far_mask else None
    return ds_nerf_kl_loss(level_history["weights"], depth_sup, steps, lengths, sigma, fg_far)


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
    """mip-NeRF 360 distortion on the final level, in normalized s-space."""
    last = ray_history[-1]
    return torch.mean(stepfuns.distortion_loss(last["sdist"], last["weights"]))
