"""Render-output visualization: colormapped depth, error maps, ray strips,
camera frusta.

Port of the reference package's `utils/vis.py` (`colorize`,
`visualize_depth`, `depth_error_map`, `ray_weight_strip`,
`plot_camera_frusta`, `side_by_side`), in numpy. The colormaps are the
tables of `utils/colormaps.py`, looked up as matplotlib looks them up, so
the images equal the reference's exactly without matplotlib. The frusta
plot projects its segments as matplotlib's default 3-D view does and
draws them itself, without axes.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from outdoor_nerf_depth_torch.data import png
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


# The reference's frusta figure: 8 x 8 in saved at 120 dpi, one 3-D Axes
# with matplotlib 3.10's defaults: elevation 30 deg, azimuth -60, roll 0,
# perspective with focal length 1 from distance 10, the view plane's limits
# (-0.95 / 10, 0.9 / 10) on both axes, the subplot box shrunk to a square
# (figure fractions: left 0.1275, bottom 0.11, side 0.77), and autoscaled
# limits: the data's range, widened by axes.{x,y,z}margin (0.05, 0.05, 0)
# and then by 1/48 a side. `set_box_aspect((1, 1, 1))` scales the box to
# 1.8294640721620434 * 25/24 / |(1, 1, 1)| a side.
FRUSTA_PX = 8 * 120
_ELEV, _AZIM, _DIST = np.deg2rad(30.0), np.deg2rad(-60.0), 10.0
_VIEW_LO, _VIEW_HI = -0.95 / _DIST, 0.9 / _DIST
_AXES_LEFT, _AXES_BOTTOM, _AXES_SIDE = 0.1275, 0.11, 0.77
_MARGINS = np.array([0.05, 0.05, 0.0])
_VIEW_MARGIN = 1.0 / 48.0
_BOX_SIDE = 1.8294640721620434 * 25.0 / 24.0 / np.sqrt(3.0)
_BLUE, _RED = (0, 0, 255), (255, 0, 0)


def frusta_segments(frusta):
    """[n, 2, 3] segments and [n] colours of the frusta dicts ({"corners":
    apex and the four image corners}), in the reference's drawing order:
    per frustum and corner i, apex to corner i in blue, then corner i to
    corner i % 4 + 1 in red."""
    segments, colours = [], []
    for fr in frusta:
        c = np.asarray(fr["corners"], np.float64)  # [5, 3]
        for i in range(1, 5):
            segments += [(c[0], c[i]), (c[i], c[1 + i % 4])]
            colours += [_BLUE, _RED]
    return np.asarray(segments, np.float64).reshape(-1, 2, 3), colours


def _autoscaled_limits(points):
    """matplotlib's autoscaled 3-D axis limits of `points` [n, 3]: (lo, hi)."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    flat = hi - lo <= 1e-15 * np.maximum(np.abs(lo), np.abs(hi))  # its `nonsingular`
    lo = np.where(flat, np.where(lo == 0, -0.05, lo - 0.05 * np.abs(lo)), lo)
    hi = np.where(flat, np.where(hi == 0, 0.05, hi + 0.05 * np.abs(hi)), hi)
    span = hi - lo
    lo, hi = lo - _MARGINS * span, hi + _MARGINS * span
    span = hi - lo
    return lo - _VIEW_MARGIN * span, hi + _VIEW_MARGIN * span


def _project(points, limits) -> np.ndarray:
    """Pixel (x right, y down) of `points` [..., 3] in the FRUSTA_PX square
    figure, for the axis `limits` from `_autoscaled_limits`."""
    lo, hi = limits
    world = (np.asarray(points, np.float64) - lo) / ((hi - lo) / _BOX_SIDE)
    w = np.array([np.cos(_ELEV) * np.cos(_AZIM), np.cos(_ELEV) * np.sin(_AZIM),
                  np.sin(_ELEV)])  # out of the screen
    eye = 0.5 * _BOX_SIDE + _DIST * w
    u = np.cross([0.0, 0.0, 1.0], w)
    u /= np.linalg.norm(u)  # to the right of the screen
    v = np.cross(w, u)  # up the screen
    rel = world - eye
    view = np.stack([rel @ u, rel @ v], axis=-1) / -(rel @ w)[..., None]
    frac = (view - _VIEW_LO) / (_VIEW_HI - _VIEW_LO) * _AXES_SIDE
    x = (_AXES_LEFT + frac[..., 0]) * FRUSTA_PX
    y = (1.0 - _AXES_BOTTOM - frac[..., 1]) * FRUSTA_PX
    return np.stack([x, y], axis=-1)


def _draw_line(canvas: np.ndarray, p0, p1, colour):
    """One-pixel line without anti-aliasing from p0 to p1 (pixel x, y),
    clipped to the canvas."""
    p0, p1 = np.asarray(p0), np.asarray(p1)
    n = int(np.ceil(np.max(np.abs(p1 - p0)))) + 1
    xy = np.floor(p0 + np.linspace(0.0, 1.0, n)[:, None] * (p1 - p0)).astype(np.int64)
    h, w = canvas.shape[:2]
    keep = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    canvas[xy[keep, 1], xy[keep, 0]] = colour


def plot_camera_frusta(frusta_json: str, out_path: str):
    """Draw the exported camera frusta (`data/preprocess.py:
    export_camera_frusta_json`) as a FRUSTA_PX square PNG: the reference's
    matplotlib view of the segments, on white, without axes, ticks, panes
    or grid. Returns the [n, 2, 2] pixel endpoints of the segments drawn."""
    with open(frusta_json) as f:
        segments, colours = frusta_segments(json.load(f)["frusta"])
    px = _project(segments, _autoscaled_limits(segments.reshape(-1, 3)))
    canvas = np.full((FRUSTA_PX, FRUSTA_PX, 3), 255, np.uint8)
    for (p0, p1), colour in zip(px, colours):
        _draw_line(canvas, p0, p1, colour)
    png.write_png(out_path, canvas)
    return px


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
