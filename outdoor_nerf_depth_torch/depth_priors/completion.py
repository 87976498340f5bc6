"""Depth completion: RGB-D encoder-decoder and guided-fusion networks.

Port of the reference package's `depth_priors/completion.py`:

* `DepthCompletionNet`, the std2019 model: modality stems split 3:1, a
  ResNet-34 basic-block encoder (`encoder_blocks=(3, 4, 6, 3)` at base 64)
  and an upsampling decoder with encoder skips.
* `GuidedCompletionNet`, the MFF-Net GuideNet family: at every scale a
  dual-direction `MMAF` exchange between the RGB guidance branch and the
  depth branch, then per-pixel kernels predicted from the guidance filter
  the depth branch (`ops.guided_conv`).

Both take rgb [N, H, W, 3] in [0, 1] and sparse depth [N, H, W] in metres
(0 = missing) and return dense depth [N, H, W] >= 0; they compute in NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from outdoor_nerf_depth_torch.depth_priors.blocks import (
    Conv,
    ConvBlock,
    ResBlock,
    crop_to,
    lecun_normal_,
    up,
)
from outdoor_nerf_depth_torch.ops.guided_conv import guided_local_conv_nchw


def _inputs(rgb, sparse_depth, depth_scale_hint: float):
    """NCHW rgb and the depth stem's input: [normalised depth, validity]."""
    d_in = (sparse_depth / depth_scale_hint)[:, None]
    valid = (sparse_depth > 0).float()[:, None]
    return rgb.permute(0, 3, 1, 2), torch.cat([d_in, valid], dim=1)


def _linear(fan_in: int, fan_out: int, generator) -> nn.Linear:
    """Flax `Dense` init: lecun_normal kernel, zero bias."""
    layer = nn.Linear(fan_in, fan_out)
    lecun_normal_(layer.weight.data, fan_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


class DepthCompletionNet(nn.Module):
    """RGB-D ResNet encoder-decoder at the std2019 reference depth.

    `base_features=64` gives the reference widths (64/128/256/512).
    """

    def __init__(self, base_features: int = 64,
                 encoder_blocks: Sequence[int] = (3, 4, 6, 3),
                 depth_scale_hint: float = 80.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = base_features, generator
        self.encoder_blocks = tuple(encoder_blocks)
        self.depth_scale_hint = depth_scale_hint
        # Modality-specific stems (reference conv1_img 48ch / conv1_d 16ch).
        self.img_stem = ConvBlock(3, 3 * f // 4, kernel=5, generator=g)
        self.depth_stem = ConvBlock(2, f - 3 * f // 4, kernel=5, generator=g)
        encoder, skip_widths, width = [], [f], f
        for stage, n_blocks in enumerate(self.encoder_blocks):
            out = f * (2 ** min(stage, 3))
            encoder.append(ResBlock(width, out, strides=2, generator=g))
            encoder += [ResBlock(out, out, generator=g) for _ in range(n_blocks - 1)]
            skip_widths.append(out)
            width = out
        self.encoder = nn.ModuleList(encoder)
        decoder = []
        for stage in range(len(self.encoder_blocks) - 1, -1, -1):
            out = f * (2 ** min(max(stage - 1, 0), 3))
            decoder += [ConvBlock(width, out, generator=g),
                        ConvBlock(out + skip_widths[stage], out, generator=g)]
            width = out
        self.decoder = nn.ModuleList(decoder)
        self.head = Conv(width, 1, 3, generator=g)
        self.flax_names = {"ConvBlock_0": "img_stem", "ConvBlock_1": "depth_stem",
                           "Conv_0": "head",
                           **{f"ResBlock_{i}": f"encoder.{i}" for i in range(len(encoder))},
                           **{f"ConvBlock_{i + 2}": f"decoder.{i}" for i in range(len(decoder))}}

    def forward(self, rgb, sparse_depth):
        rgb, depth_in = _inputs(rgb, sparse_depth, self.depth_scale_hint)
        x = torch.cat([self.img_stem(rgb), self.depth_stem(depth_in)], dim=1)  # full res, f ch
        skips, blocks = [x], iter(self.encoder)
        for n_blocks in self.encoder_blocks:  # 1/2, 1/4, 1/8, 1/16
            for _ in range(n_blocks):
                x = next(blocks)(x)
            skips.append(x)
        for i, stage in enumerate(range(len(self.encoder_blocks) - 1, -1, -1)):
            skip = skips[stage]
            x = crop_to(up(self.decoder[2 * i](x)), skip)
            x = self.decoder[2 * i + 1](torch.cat([x, skip], dim=1))
        return F.relu(self.head(x)[:, 0]) * self.depth_scale_hint


class _GuidedFusion(nn.Module):
    """Guidance features -> per-pixel kernels (softmax over the taps) ->
    filter the depth branch. NCHW."""

    flax_names = {"Conv_0": "kernels"}

    def __init__(self, features: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k_sq = kernel_size**2
        self.kernels = Conv(features, self.k_sq * features, 3, generator=generator)

    def forward(self, guide_feat, depth_feat):
        kernels = self.kernels(guide_feat)
        n, _, h, w = kernels.shape
        kernels = torch.softmax(kernels.view(n, self.k_sq, -1, h, w), dim=1)
        return guided_local_conv_nchw(depth_feat, kernels)


class MMAF(nn.Module):
    """Dual-direction multi-modal attention fusion (MFF-Net MMAF blocks):
    each branch gates the other with channel attention from globally pooled
    joint statistics and receives the gated cross-modal features through a
    zero-initialised conv, so the block starts as the identity. Returns the
    updated (guide, depth) pair. NCHW."""

    flax_names = {"Dense_0": "hidden", "Dense_1": "gates"}

    def __init__(self, features: int, reduction: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.features = features
        self.hidden = _linear(2 * features, max(4, 2 * features // reduction), g)
        self.gates = _linear(self.hidden.out_features, 2 * features, g)
        self.inject_g2d = Conv(features, features, 3, zero_init=True)
        self.inject_d2g = Conv(features, features, 3, zero_init=True)

    def forward(self, guide_feat, depth_feat):
        pooled = torch.cat([guide_feat, depth_feat], dim=1).mean(dim=(2, 3))  # [N, 2C]
        gates = self.gates(F.relu(self.hidden(pooled)))
        g2d = torch.sigmoid(gates[:, : self.features])[:, :, None, None]
        d2g = torch.sigmoid(gates[:, self.features:])[:, :, None, None]
        new_depth = depth_feat + self.inject_g2d(guide_feat * g2d)
        new_guide = guide_feat + self.inject_d2g(depth_feat * d2g)
        return new_guide, new_depth


class GuidedCompletionNet(nn.Module):
    """Two-branch guided completion (MFF-Net GuideNet) at widths f, 2f, 4f."""

    def __init__(self, base_features: int = 32, depth_scale_hint: float = 80.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = base_features, generator
        self.depth_scale_hint = depth_scale_hint
        widths = (f, 2 * f, 4 * f)
        self.guide_stem = ConvBlock(3, f, generator=g)
        self.depth_stem = ConvBlock(2, f, generator=g)
        self.guide_res = nn.ModuleList(ResBlock(i, o, strides=2, generator=g)
                                       for i, o in zip(widths, widths[1:]))
        self.depth_res = nn.ModuleList(ResBlock(i, o, strides=2, generator=g)
                                       for i, o in zip(widths, widths[1:]))
        self.mmaf = nn.ModuleList(MMAF(w, generator=g) for w in widths)
        self.fusion = nn.ModuleList(_GuidedFusion(w, generator=g) for w in widths)
        self.up1 = ConvBlock(4 * f, 2 * f, generator=g)
        self.fuse1 = ConvBlock(4 * f, 2 * f, generator=g)
        self.fuse0 = ConvBlock(3 * f, f, generator=g)
        self.head = Conv(f, 1, 3, generator=g)
        names = {"ConvBlock_0": "guide_stem", "ConvBlock_1": "depth_stem", "ConvBlock_2": "up1",
                 "ConvBlock_3": "fuse1", "ConvBlock_4": "fuse0", "Conv_0": "head"}
        for i in range(len(widths)):
            names[f"MMAF_{i}"] = f"mmaf.{i}"
            names[f"_GuidedFusion_{i}"] = f"fusion.{i}"
        for i in range(len(widths) - 1):  # guide then depth, stage by stage
            names[f"ResBlock_{2 * i}"] = f"guide_res.{i}"
            names[f"ResBlock_{2 * i + 1}"] = f"depth_res.{i}"
        self.flax_names = names

    def forward(self, rgb, sparse_depth):
        rgb, depth_in = _inputs(rgb, sparse_depth, self.depth_scale_hint)
        g, d = self.guide_stem(rgb), self.depth_stem(depth_in)
        skips = []
        for stage in range(len(self.mmaf)):
            if stage > 0:
                g, d = self.guide_res[stage - 1](g), self.depth_res[stage - 1](d)
            g, d = self.mmaf[stage](g, d)
            d = self.fusion[stage](g, d)
            skips.append(d)
        d0, d1, d2 = skips
        u1 = crop_to(up(self.up1(d2)), d1)
        u1 = self.fuse1(torch.cat([u1, d1], dim=1))
        u0 = crop_to(up(u1), d0)
        u0 = self.fuse0(torch.cat([u0, d0], dim=1))
        return F.relu(self.head(u0)[:, 0]) * self.depth_scale_hint


# --------------------------------------------------------------------------
# Losses (std2019 criteria + smoothness), on [N, H, W] depth.
# --------------------------------------------------------------------------


def masked_depth_mse(pred, target):
    """MSE over pixels with LiDAR returns (target > 0)."""
    mask = (target > 0).to(pred.dtype)
    return torch.sum(mask * (pred - target) ** 2) / torch.clamp(mask.sum(), min=1.0)


def masked_depth_l1(pred, target):
    mask = (target > 0).to(pred.dtype)
    return torch.sum(mask * torch.abs(pred - target)) / torch.clamp(mask.sum(), min=1.0)


def edge_aware_smoothness(depth, rgb):
    """Image-gradient-weighted depth smoothness; rgb [N, H, W, 3]."""
    dzdx = torch.abs(depth[:, :, 1:] - depth[:, :, :-1])
    dzdy = torch.abs(depth[:, 1:, :] - depth[:, :-1, :])
    didx = torch.abs(rgb[:, :, 1:] - rgb[:, :, :-1]).mean(-1)
    didy = torch.abs(rgb[:, 1:, :] - rgb[:, :-1, :]).mean(-1)
    return torch.mean(dzdx * torch.exp(-didx)) + torch.mean(dzdy * torch.exp(-didy))


def photometric_loss(pred_img, target_img, mask=None):
    """L1 photometric consistency between a warped view and the target."""
    err = torch.abs(pred_img - target_img).mean(-1)
    if mask is not None:
        m = mask.to(err.dtype)
        return torch.sum(m * err) / torch.clamp(m.sum(), min=1.0)
    return torch.mean(err)
