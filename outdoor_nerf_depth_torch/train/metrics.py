"""Image and depth quality metrics.

Port of the reference package's `train/metrics.py`: PSNR/MSE, SSIM (11-tap
Gaussian window, separable, VALID region; skimage's convention), and the
KITTI depth battery with predictions divided by the scene's `depth_scale`
back to metres and clamped to [1e-3, 80 m]. `MetricSuite` takes host arrays
and computes in float32 on the CPU. LPIPS is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

DEPTH_CAP_M = 80.0
DEPTH_FLOOR_M = 1e-3


def mse_to_psnr(mse):
    return -10.0 / math.log(10.0) * torch.log(torch.as_tensor(mse))


def psnr(pred, target):
    return mse_to_psnr(torch.mean((pred - target) ** 2))


def ssim(pred, target, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Structural similarity on [H, W, C] images in [0, 1]."""
    pred = torch.clip(pred, 0.0, max_val)
    target = torch.clip(target, 0.0, max_val)
    # Shrink the window for tiny images so the VALID output is non-empty.
    filter_size = min(filter_size, pred.shape[0], pred.shape[1])
    offsets = torch.arange(filter_size, dtype=pred.dtype, device=pred.device) - filter_size // 2
    kernel = torch.exp(-0.5 * (offsets / filter_sigma) ** 2)
    kernel = (kernel / kernel.sum()).reshape(1, 1, filter_size)

    def blur(img):
        def conv1d(x, axis):
            x = torch.movedim(x, axis, -1)
            shape = x.shape
            out = F.conv1d(x.reshape(-1, 1, shape[-1]), kernel)
            return torch.movedim(out.reshape(shape[:-1] + out.shape[-1:]), -1, axis)

        return conv1d(conv1d(img, 0), 1)

    mu_p, mu_t = blur(pred), blur(target)
    mu_pp, mu_tt, mu_pt = blur(pred**2), blur(target**2), blur(pred * target)
    # Clamp: roundoff can make E[x^2] - E[x]^2 slightly negative.
    var_p = torch.clamp(mu_pp - mu_p**2, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t**2, min=0.0)
    cov = mu_pt - mu_p * mu_t
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    )
    return ssim_map.mean()


def depth_metrics(pred, gt, depth_scale: float = 1.0, cap: float = DEPTH_CAP_M,
                  valid_mask: Optional[torch.Tensor] = None):
    """KITTI depth battery in metres: abs_rel, sq_rel, rmse, rmse_log, delta_1..3, n_valid."""
    pred_m = torch.clip(pred / depth_scale, DEPTH_FLOOR_M, cap)
    gt_m = gt / depth_scale
    mask = gt_m > 0
    if valid_mask is not None:
        mask = mask & valid_mask
    mask = mask & (gt_m <= cap)
    m = mask.to(torch.float32)
    n = torch.clamp(m.sum(), min=1.0)
    gt_safe = torch.where(mask, gt_m, torch.ones_like(gt_m))
    pred_safe = torch.where(mask, pred_m, torch.ones_like(pred_m))
    err = pred_safe - gt_safe
    ratio = torch.maximum(pred_safe / gt_safe, gt_safe / pred_safe)
    mean = lambda x: (m * x).sum() / n
    return {
        "abs_rel": mean(err.abs() / gt_safe),
        "sq_rel": mean(err**2 / gt_safe),
        "rmse": torch.sqrt(mean(err**2)),
        "rmse_log": torch.sqrt(mean((torch.log(pred_safe) - torch.log(gt_safe)) ** 2)),
        "delta_1": mean((ratio < 1.25).to(torch.float32)),
        "delta_2": mean((ratio < 1.25**2).to(torch.float32)),
        "delta_3": mean((ratio < 1.25**3).to(torch.float32)),
        "n_valid": m.sum(),
    }


class MetricSuite:
    """PSNR/SSIM + depth metrics over full rendered images (host arrays)."""

    def __init__(self, compute_ssim: bool = True, compute_lpips: bool = False):
        if compute_lpips:
            raise NotImplementedError("LPIPS is not ported yet")
        self.compute_ssim = compute_ssim

    def __call__(self, pred_rgb, gt_rgb, pred_depth=None, gt_depth=None, depth_scale=1.0):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
        pred_rgb, gt_rgb = t(pred_rgb), t(gt_rgb)
        out = {"psnr": float(psnr(pred_rgb, gt_rgb))}
        if self.compute_ssim:
            out["ssim"] = float(ssim(pred_rgb, gt_rgb))
        if pred_depth is not None and gt_depth is not None:
            out.update(
                {k: float(v) for k, v in depth_metrics(t(pred_depth), t(gt_depth), depth_scale).items()}
            )
        return out
