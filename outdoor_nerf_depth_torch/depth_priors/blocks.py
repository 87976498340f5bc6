"""Shared conv building blocks for the depth-prior networks.

Port of the reference package's `depth_priors/blocks.py`. The modules
compute in NCHW (2D) and NCDHW (3D), the layouts cuDNN takes; the public
resize helpers `upsample2d`/`upsample3d` take and return NHWC/NDHWC as the
reference's do. What the port keeps of Flax's conventions:

* `padding="SAME"` pads `total = max((ceil(n/s) - 1) * s + (k - 1) * d + 1 - n, 0)`
  per spatial dimension, `total // 2` before and the rest after. For a 3x3
  stride-2 conv on an even size that is (0, 1), not torch's symmetric 1:
  `Conv` pads explicitly where the two sides differ.
* GroupNorm has epsilon 1e-6 and `min(8, features)` groups.
* Initialisation: kernels from `lecun_normal` (a fan-in truncated normal),
  zero biases, GroupNorm scale 1 and bias 0.
* Each module lists `flax_names`, Flax's auto-names of its children
  (`ConvBlock_0`, `ResBlock_3`, ...) against the torch attribute paths, so
  `convert.params_from_flax` can load a Flax tree.

Modules take their input width as the first argument (Flax infers it).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUPNORM_EPS = 1e-6
# Standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Flax's `lecun_normal`: a normal truncated to [-2, 2] standard
    deviations, scaled to variance 1 / fan_in. Drawn by inverse CDF from one
    uniform per element, so a generator gives the same weights on every
    torch version (`nn.init.trunc_normal_` changed its sampling method)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    edge = math.erf(-2.0 / math.sqrt(2.0))  # 2 * cdf(-2) - 1
    with torch.no_grad():
        weight.uniform_(edge, -edge, generator=generator).erfinv_()
        return weight.mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(before, after) padding of Flax's `padding="SAME"` along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax `nn.Conv(padding="SAME")` over NC... tensors, 2D or 3D.

    The weight is [out, in, *kernel] (a Flax kernel is [*kernel, in, out]).
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3, strides: int = 1,
                 dilation: int = 1, use_bias: bool = True, dims: int = 2, zero_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.strides, self.dilation, self.dims = kernel, strides, dilation, dims
        self.weight = nn.Parameter(torch.zeros((features, in_features) + (kernel,) * dims))
        if not zero_init:
            lecun_normal_(self.weight.data, in_features * kernel**dims, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        pads = [same_pads(n, self.kernel, self.strides, self.dilation) for n in x.shape[2:]]
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        conv = F.conv2d if self.dims == 2 else F.conv3d
        return conv(x, self.weight, self.bias, self.strides, padding, self.dilation)


def group_norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(8, features), features, eps=GROUPNORM_EPS)


class ConvBlock(nn.Module):
    """Conv -> GroupNorm -> ReLU (the depth nets' conv_bn_relu), NCHW."""

    flax_names = {"Conv_0": "conv", "GroupNorm_0": "norm"}
    dims = 2

    def __init__(self, in_features: int, features: int, kernel: int = 3, strides: int = 1,
                 dilation: int = 1, use_norm: bool = True, use_act: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(in_features, features, kernel, strides, dilation, use_bias=not use_norm,
                         dims=self.dims, generator=generator)
        self.norm = group_norm(features) if use_norm else None
        self.use_act = use_act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.use_act else x


class Conv3dBlock(ConvBlock):
    """3D conv -> GroupNorm -> ReLU over [N, C, D, H, W] cost volumes."""

    dims = 3

    def __init__(self, in_features: int, features: int, kernel: int = 3, strides: int = 1,
                 use_norm: bool = True, use_act: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, kernel, strides, 1, use_norm, use_act, generator)


class ResBlock(nn.Module):
    """Two 3x3 convs with identity (or projected) shortcut."""

    flax_names = {"ConvBlock_0": "conv1", "ConvBlock_1": "conv2", "ConvBlock_2": "shortcut"}

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvBlock(in_features, features, strides=strides, generator=generator)
        self.conv2 = ConvBlock(features, features, use_act=False, generator=generator)
        self.shortcut = None
        if in_features != features or strides != 1:
            self.shortcut = ConvBlock(in_features, features, kernel=1, strides=strides,
                                      use_act=False, generator=generator)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


def resize(x, size: Sequence[int]):
    """Linear resize of the spatial dims of an NC... tensor with half-pixel
    centres. When upsampling this equals the reference's bilinear/trilinear
    image resize: at the edges that renormalises its weights over the pixels
    inside, torch clamps the sample position, and both give the edge pixel."""
    mode = "bilinear" if x.dim() == 4 else "trilinear"
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=False)


def up(x, factor: int = 2):
    """`resize` of an NC... tensor by an integer factor in every spatial dim."""
    return resize(x, [n * factor for n in x.shape[2:]])


def upsample2d(x, factor: int = 2):
    """[N, H, W, C] -> [N, H*f, W*f, C], bilinear."""
    return up(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def upsample3d(x, factor: int = 2):
    """[N, D, H, W, C] -> [N, D*f, H*f, W*f, C], trilinear."""
    return up(x.permute(0, 4, 1, 2, 3), factor).permute(0, 2, 3, 4, 1)


def crop_to(x, ref):
    """Crop the spatial dims of `x` to those of `ref` (both NC...)."""
    return x[(slice(None), slice(None)) + tuple(slice(0, n) for n in ref.shape[2:])]


class Hourglass3d(nn.Module):
    """Encoder-decoder over a cost volume with skip connections.

    The aggregation block every cost-volume stereo net shares (CFNet's
    `hourglass`/PCWNet's `hourglass_1`). Input and output have `features`
    channels.
    """

    def __init__(self, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        self.down1a = Conv3dBlock(f, f * 2, strides=2, generator=g)
        self.down1b = Conv3dBlock(f * 2, f * 2, generator=g)
        self.down2a = Conv3dBlock(f * 2, f * 4, strides=2, generator=g)
        self.down2b = Conv3dBlock(f * 4, f * 4, generator=g)
        self.up1 = Conv3dBlock(f * 4, f * 2, use_act=False, generator=g)
        self.up0 = Conv3dBlock(f * 2, f, use_act=False, generator=g)
        order = ("down1a", "down1b", "down2a", "down2b", "up1", "up0")
        self.flax_names = {f"Conv3dBlock_{i}": name for i, name in enumerate(order)}

    def forward(self, x):
        d1 = self.down1b(self.down1a(x))
        d2 = self.down2b(self.down2a(d1))
        u1 = F.relu(self.up1(crop_to(up(d2), d1)) + d1)
        return F.relu(self.up0(crop_to(up(u1), x)) + x)


class UNetFeatures(nn.Module):
    """Pyramid feature extractor returning the {1/4, 1/8, 1/16} scale maps
    (2f, 4f and 8f channels), NCHW."""

    def __init__(self, base_features: int = 32, in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = base_features, generator
        self.stem = ConvBlock(in_features, f, strides=2, generator=g)  # 1/2
        widths = [(f, f, 1), (f, 2 * f, 2), (2 * f, 2 * f, 1), (2 * f, 4 * f, 2),
                  (4 * f, 4 * f, 1), (4 * f, 8 * f, 2), (8 * f, 8 * f, 1)]
        self.res = nn.ModuleList(ResBlock(i, o, s, generator=g) for i, o, s in widths)
        # Fuse coarse context back into the finer maps (UNet-style).
        self.fuse8 = ConvBlock(12 * f, 4 * f, generator=g)
        self.fuse4 = ConvBlock(6 * f, 2 * f, generator=g)
        self.flax_names = {"ConvBlock_0": "stem", "ConvBlock_1": "fuse8", "ConvBlock_2": "fuse4",
                           **{f"ResBlock_{i}": f"res.{i}" for i in range(len(widths))}}

    def forward(self, x):
        s1 = self.res[0](self.stem(x))
        s2 = self.res[2](self.res[1](s1))  # 1/4
        s3 = self.res[4](self.res[3](s2))  # 1/8
        s4 = self.res[6](self.res[5](s3))  # 1/16
        s3 = self.fuse8(torch.cat([s3, crop_to(up(s4), s3)], dim=1))
        s2 = self.fuse4(torch.cat([s2, crop_to(up(s3), s2)], dim=1))
        return s2, s3, s4
