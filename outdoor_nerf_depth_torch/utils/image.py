"""Image-space utilities: sRGB transfer, resampling, colour alignment, IO.

Port of the reference package's `utils/image.py`. The transfer curves and
`downsample` compute in torch (they take tensors or arrays and return
tensors); `color_correct` is the reference's float64 numpy least squares.
The savers write through the port's own PNG codec (`data/png.py`) and keep
the reference's truncating codes.
"""

from __future__ import annotations

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import png

_EPS = float(np.finfo(np.float32).eps)


def srgb_to_linear(srgb):
    """IEC 61966-2-1 electro-optical transfer (the exact piecewise curve)."""
    srgb = torch.as_tensor(srgb)
    linear0 = 25.0 * srgb / 323.0
    linear1 = torch.clamp((200.0 * srgb + 11.0) / 211.0, min=_EPS) ** (12.0 / 5.0)
    return torch.where(srgb <= 0.04045, linear0, linear1)


def linear_to_srgb(linear):
    linear = torch.as_tensor(linear)
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp(linear, min=_EPS) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def downsample(img, factor: int):
    """Exact area downsampling by an integer factor (box filter)."""
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    if h % factor or w % factor:
        raise ValueError(f"image {tuple(img.shape)} not divisible by factor {factor}")
    shape = (h // factor, factor, w // factor, factor) + tuple(img.shape[2:])
    return img.reshape(shape).mean(dim=(1, 3))


def color_correct(img, ref, num_iters: int = 5, eps: float = 0.5 / 255):
    """Per-channel quadratic colour alignment of `img` onto `ref`.

    Solves a clipped least-squares warp over [rgb, rgb^2 cross-terms, 1]
    features per channel, iterating to handle the clipping, to compare
    renders fairly under exposure drift.
    """
    img_np = np.asarray(img, dtype=np.float64)
    ref_np = np.asarray(ref, dtype=np.float64)
    if img_np.shape[-1] != ref_np.shape[-1]:
        raise ValueError("channel mismatch")
    num_channels = img_np.shape[-1]
    img_mat = img_np.reshape(-1, num_channels)
    ref_mat = ref_np.reshape(-1, num_channels)

    def quad_feats(mat):
        quads = [mat[:, i : i + 1] * mat[:, j : j + 1]
                 for i in range(num_channels) for j in range(i, num_channels)]
        return np.concatenate([mat] + quads + [np.ones_like(mat[:, :1])], axis=-1)

    out = img_mat.copy()
    for _ in range(num_iters):
        feats = quad_feats(out)
        for c in range(num_channels):
            # Only fit where neither side is clipped.
            mask = (
                (img_mat[:, c] > eps) & (img_mat[:, c] < 1 - eps)
                & (ref_mat[:, c] > eps) & (ref_mat[:, c] < 1 - eps)
            )
            coeff, *_ = np.linalg.lstsq(feats[mask], ref_mat[mask, c], rcond=None)
            out[:, c] = np.clip(feats @ coeff, 0.0, 1.0)
    return out.reshape(img_np.shape).astype(np.float32)


def to_u8(img) -> np.ndarray:
    """The reference's 8-bit codes of a [0, 1] float image: NaN becomes 0,
    then the clipped value times 255 is truncated, not rounded."""
    return (np.clip(np.nan_to_num(np.asarray(img)), 0.0, 1.0) * 255.0).astype(np.uint8)


def save_img_u8(img, path: str):
    """Save a [0, 1] float image ([H, W] or [H, W, 3]) as an 8-bit PNG."""
    png.write_png(path, to_u8(img))


def save_depth_u16(depth_m, path: str):
    """Save metric depth as a KITTI-convention uint16 PNG (metres * 256).

    The codes are the reference's: NaN becomes 0, then the value times 256
    is clipped to [0, 65535] and truncated to an integer.
    """
    arr = np.clip(np.nan_to_num(np.asarray(depth_m)) * 256.0, 0, 65535).astype(np.uint16)
    png.write_png(path, arr)
