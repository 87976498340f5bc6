"""Render-output visualization: colormapped depth, error maps, ray strips.

Port of the reference package's `utils/vis.py` (`colorize`,
`visualize_depth`, `depth_error_map`, `ray_weight_strip`, `side_by_side`),
in numpy. The colormaps are the tables of `utils/colormaps.py`, looked up
as matplotlib looks them up, so the images equal the reference's exactly
without matplotlib.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from outdoor_nerf_depth_torch.utils import colormaps


def lookup(x, name: str) -> np.ndarray:
    """matplotlib's `colormaps[name](x)[..., :3]` for float x: entry
    floor(x * 256), 1.0 in the last entry, values below 0 or above 1 in the
    end entries, NaN in the bad colour."""
    table = np.asarray(colormaps.TABLES[name], np.float64)
    n = len(table)
    xa = np.array(x, dtype=np.float64) * n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0.0, xa), 0, n - 1).astype(np.int64)
    rgb = table[idx]
    rgb[bad] = colormaps.BAD
    return rgb


def colorize(
    value: np.ndarray,
    cmap: str = "turbo",
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    invalid_color=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Map a scalar image to RGB with nan/invalid handling. Returns [H,W,3]."""
    value = np.asarray(value, dtype=np.float64)
    valid = np.isfinite(value)
    vmin = np.min(value[valid]) if vmin is None else vmin
    vmax = np.max(value[valid]) if vmax is None else vmax
    normed = np.clip((value - vmin) / max(1e-12, vmax - vmin), 0.0, 1.0)
    rgb = lookup(normed, cmap)
    rgb[~valid] = invalid_color
    return rgb.astype(np.float32)


def visualize_depth(
    depth,
    acc: Optional[np.ndarray] = None,
    percentile_clip: float = 99.0,
    cmap: str = "turbo",
) -> np.ndarray:
    """Disparity-space depth visualization, opacity-dimmed where acc is low."""
    depth = np.asarray(depth)
    disp = 1.0 / np.maximum(1e-6, depth)
    vmax = np.percentile(disp[np.isfinite(disp)], percentile_clip)
    rgb = colorize(disp, cmap=cmap, vmin=0.0, vmax=vmax)
    if acc is not None:
        rgb = rgb * np.clip(np.asarray(acc), 0.0, 1.0)[..., None]
    return rgb


def depth_error_map(pred, gt, cap: float = 80.0, cmap: str = "coolwarm"):
    """Signed depth error (pred - gt, metres), gray where gt invalid."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    valid = gt > 0
    err = np.where(valid, np.clip(pred, 0, cap) - np.clip(gt, 0, cap), np.nan)
    bound = np.nanpercentile(np.abs(err), 95) if valid.any() else 1.0
    return colorize(err, cmap=cmap, vmin=-bound, vmax=bound,
                    invalid_color=(0.5, 0.5, 0.5))


def ray_weight_strip(tdist, weights, width: int = 512) -> np.ndarray:
    """Rows = rays, columns = normalized distance; intensity = weight density,
    resampled to a uniform grid for display."""
    tdist = np.asarray(tdist)
    weights = np.asarray(weights)
    n_rays = tdist.shape[0]
    grid = np.linspace(0.0, 1.0, width)
    out = np.zeros((n_rays, width), dtype=np.float32)
    for i in range(n_rays):
        t = tdist[i]
        span = max(1e-12, t[-1] - t[0])
        t01 = (t - t[0]) / span
        density = weights[i] / np.maximum(1e-12, np.diff(t01))
        idx = np.clip(np.searchsorted(t01, grid, side="right") - 1, 0,
                      len(density) - 1)
        inside = (grid >= t01[0]) & (grid <= t01[-1])
        out[i] = np.where(inside, density[idx], 0.0)
    out /= max(1e-12, out.max())
    return colorize(out, cmap="viridis")


def side_by_side(*images) -> np.ndarray:
    """Horizontally concatenate [H,W,3] images with 2px white separators."""
    images = [np.asarray(im, dtype=np.float32) for im in images]
    h = max(im.shape[0] for im in images)
    sep = np.ones((h, 2, 3), np.float32)
    padded = []
    for im in images:
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        pad = h - im.shape[0]
        if pad:
            im = np.pad(im, ((0, pad), (0, 0), (0, 0)))
        padded.extend([im, sep])
    return np.concatenate(padded[:-1], axis=1)
