"""Content-guided (spatially-varying) local convolution.

Port of the reference package's `ops/guided_conv.py`, the MFF-Net
`GuideConv` op: z[b, y, x, c] = sum_k x[b, y+dy_k, x+dx_k, c] * w[b, y, x, k, c],
every pixel carrying its own KxK depthwise kernel predicted by a guidance
branch. The reference computes it as a patch extraction and one einsum, and
so does the port (plain torch; it was never a Pallas kernel), in the NCHW
layout the completion nets compute in; the NHWC functions, the reference's
signatures, permute around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _kernel_size(k_sq: int) -> int:
    k = int(round(k_sq**0.5))
    if k * k != k_sq:
        raise ValueError(f"weights kernel dim {k_sq} is not a square")
    return k


def _patches_nchw(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, K*K, C, H, W], zero-padded, taps in row-major order."""
    b, c, h, w = x.shape
    cols = F.unfold(x, k, padding=k // 2)  # [B, C*K*K, H*W], channel-major
    return cols.view(b, c, k * k, h, w).transpose(1, 2)


def extract_patches(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """im2col for NHWC inputs: [B, H, W, C] -> [B, H, W, K*K, C], zero-padded."""
    return _patches_nchw(x.permute(0, 3, 1, 2), kernel_size).permute(0, 3, 4, 1, 2)


def guided_local_conv_nchw(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Apply per-pixel depthwise kernels: x [B, C, H, W] and weights
    [B, K*K, C, H, W] -> [B, C, H, W]."""
    k = _kernel_size(weights.shape[1])
    # Mixed dtypes promote, as the reference's einsum does.
    dtype = torch.promote_types(x.dtype, weights.dtype)
    return torch.einsum("bkchw,bkchw->bchw", _patches_nchw(x.to(dtype), k), weights.to(dtype))


def guided_local_conv(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """`guided_local_conv_nchw` on NHWC: x [B, H, W, C], weights [B, H, W, K*K, C]."""
    return guided_local_conv_nchw(x.permute(0, 3, 1, 2),
                                  weights.permute(0, 3, 4, 1, 2)).permute(0, 2, 3, 1)
