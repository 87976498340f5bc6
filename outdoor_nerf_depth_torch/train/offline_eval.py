"""Offline evaluator: compare rendered images on disk against ground truth.

Port of the reference package's `train/offline_eval.py`: given a directory
of test renders and the scene's image folder, recompute the test split
(every 10th view from index 9), evaluate PSNR/SSIM (and LPIPS when asked)
per image, and write a per-image metric file with the mean appended.

Predictions may be named `color_###.png` (mip-NeRF 360 dumps and the
port's `evaluate`), `######.png` or `########.png` (NeRF++ dumps), or
`pred_###.png`. Images are PNGs: the port has no JPEG decoder.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from outdoor_nerf_depth_torch.data import datasets as datasets_lib
from outdoor_nerf_depth_torch.train import metrics as metrics_lib


def _find_pred(pred_dir: str, i: int) -> Optional[str]:
    for name in (f"color_{i:03d}.png", f"{i:06d}.png", f"{i:08d}.png", f"pred_{i:03d}.png"):
        p = os.path.join(pred_dir, name)
        if os.path.exists(p):
            return p
    return None


def evaluate_renders(gt_image_dir: str, pred_dir: str, out_path: Optional[str] = None,
                     compute_lpips: bool = False, log_fn=print, device=None):
    """Evaluate predicted renders against the scene's test views.

    LPIPS, when asked, runs on `device` (None means CUDA). Returns
    (per_image: list of dicts, mean: dict).
    """
    files = sorted(os.listdir(gt_image_dir))
    test_idx = datasets_lib.split_indices(len(files), "test")
    suite = metrics_lib.MetricSuite(compute_ssim=True, compute_lpips=compute_lpips, device=device)

    per_image, lines = [], []
    for rank, idx in enumerate(test_idx):
        gt = datasets_lib.load_image(os.path.join(gt_image_dir, files[idx])) / 255.0
        pred_path = _find_pred(pred_dir, rank)
        if pred_path is None:
            log_fn(f"missing prediction for test view {rank} (gt idx {idx})")
            continue
        pred = datasets_lib.load_image(pred_path) / 255.0
        if pred.shape != gt.shape:
            raise ValueError(f"shape mismatch: pred {pred.shape} vs gt {gt.shape} at {pred_path}")
        m = suite(pred.astype(np.float32), gt.astype(np.float32))
        per_image.append(m)
        lines.append(f"{files[idx]} " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        log_fn(lines[-1])

    if not per_image:
        raise ValueError(f"no evaluable predictions found in {pred_dir}")
    mean = {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0]}
    lines.append("mean " + " ".join(f"{k}={v:.4f}" for k, v in mean.items()))
    log_fn(lines[-1])
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return per_image, mean
