"""Cost-volume stereo matching (the CFNet / PCWNet prior generators).

Port of the reference package's `depth_priors/stereo.py`: pyramid
features, group-wise correlation + concat cost volumes built by static
shifts, 3D-hourglass aggregation, soft-argmin disparity regression with
multi-scale outputs, and the distribution variance as uncertainty, which
drives the confidence-filtered `ste_conf` prior and the cascaded
variable-range stage. `variant="cfnet"` fuses two scales; `"pcwnet"` adds
the 1/16 volume and a warping volume at 1/8.

The public functions take and return NHWC ([N, D, H, W, C] for volumes) as
the reference's do; `StereoNet` computes in NCHW/NCDHW inside. `dtype`
(float32 by default) is the convolutions' compute dtype, as in the
reference: under bfloat16 the logits come out in bf16 and the soft-argmin
promotes them against the float32 disparities.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from outdoor_nerf_depth_torch.depth_priors.blocks import (
    Conv,
    Conv3dBlock,
    Hourglass3d,
    UNetFeatures,
    resize,
    up,
)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _shift_nchw(x, disparity: int):
    """Shift along W by `disparity` pixels, zero-filled: right if > 0, left if < 0."""
    if disparity == 0:
        return x
    if disparity > 0:
        return F.pad(x, (disparity, 0))[..., : x.shape[-1]]
    return F.pad(x, (0, -disparity))[..., -disparity:]


def shift_right_features(right, disparity: int):
    """Shift the right image's features [N, H, W, C] by `disparity` pixels (zero-fill)."""
    return _nhwc(_shift_nchw(_nchw(right), disparity))


def shift_left_features(right, disparity: int):
    """Shift features [N, H, W, C] left by `disparity` pixels (zero-fill on the right)."""
    return _nhwc(_shift_nchw(_nchw(right), -disparity))


def _gwc_nchw(left, right, num_groups: int):
    """[N, C, H, W] pair -> [N, G, H, W] per-group mean dot product."""
    n, c, h, w = left.shape
    return (left * right).view(n, num_groups, c // num_groups, h, w).mean(2)


def groupwise_correlation(left, right, num_groups: int):
    """Per-group mean dot product along channels: [N, H, W, G]."""
    return _nhwc(_gwc_nchw(_nchw(left), _nchw(right), num_groups))


def _cost_volume_nchw(left, right, max_disp: int, num_groups: int, concat_features: int):
    """[N, C, H, W] pair -> [N, G + 2*Cc, D, H, W] gwc+concat volume."""
    slices = []
    lc = left[:, :concat_features]
    for d in range(max_disp):
        rs = _shift_nchw(right, d)
        vol = torch.cat([_gwc_nchw(left, rs, num_groups), lc, rs[:, :concat_features]], dim=1)
        # Left-of-disparity columns see zero-filled right features; mask them
        # so the volume doesn't hallucinate matches off the image.
        if d > 0:
            vol[..., :d] = 0.0
        slices.append(vol)
    return torch.stack(slices, dim=2)


def build_cost_volume(left, right, max_disp: int, num_groups: int, concat_features: int):
    """Dense [N, D, H, W, G + 2*Cc] gwc+concat cost volume by static shifts."""
    vol = _cost_volume_nchw(_nchw(left), _nchw(right), max_disp, num_groups, concat_features)
    return vol.permute(0, 2, 3, 4, 1)


def disparity_regression(logits, disp_values):
    """Soft-argmin: probability-weighted disparity + distribution variance.

    `logits` is [N, D, H, W]; `disp_values` a global [D] vector or per-pixel
    hypotheses [N, D, H, W]. Returns (disparity [N, H, W], variance [N, H, W]);
    the variance is CFNet's uncertainty.
    """
    prob = torch.softmax(logits, dim=1)
    d = disp_values if disp_values.dim() == 4 else disp_values.view(1, -1, 1, 1)
    mean = (prob * d).sum(1)
    var = (prob * (d - mean[:, None]) ** 2).sum(1)
    return mean, var


def _warp_nchw(feat, disp):
    """Sample features [N, C, H, W] at x - disp (bilinear along W); disp [N, H, W]."""
    w = feat.shape[-1]
    xs = torch.arange(w, dtype=torch.float32, device=feat.device) - disp
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    t = torch.clamp(xs - x0, 0.0, 1.0)[:, None]
    size = feat.shape
    f0 = torch.gather(feat, 3, x0.long()[:, None].expand(size))
    f1 = torch.gather(feat, 3, x1.long()[:, None].expand(size))
    valid = ((xs >= 0) & (xs <= w - 1))[:, None]
    return (f0 * (1.0 - t) + f1 * t) * valid


def warp_by_disparity(feat, disp):
    """Sample features [N, H, W, C] at x - disp (bilinear along width)."""
    return _nhwc(_warp_nchw(_nchw(feat), disp))


class CostVolumeStage(nn.Module):
    """One aggregation stage: 3D convs + hourglasses -> disparity logits [N, D, H, W]."""

    def __init__(self, in_features: int, features: int = 32, num_hourglasses: int = 2,
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        g, dt = generator, dtype
        self.conv0 = Conv3dBlock(in_features, features, generator=g, dtype=dt)
        self.conv1 = Conv3dBlock(features, features, generator=g, dtype=dt)
        self.hourglasses = nn.ModuleList(Hourglass3d(features, generator=g, dtype=dt)
                                         for _ in range(num_hourglasses))
        self.logits = Conv(features, 1, 3, dims=3, generator=g, dtype=dt)
        self.flax_names = {"Conv3dBlock_0": "conv0", "Conv3dBlock_1": "conv1", "Conv_0": "logits",
                           **{f"Hourglass3d_{i}": f"hourglasses.{i}"
                              for i in range(num_hourglasses)}}

    def forward(self, volume):
        x = self.conv1(self.conv0(volume))
        for hourglass in self.hourglasses:
            x = hourglass(x)
        return self.logits(x)[:, 0]


class StereoNet(nn.Module):
    """Cascaded cost-volume stereo network.

    Stage 1 covers the full disparity range at 1/8 resolution; stage 2
    refines at 1/4 with CFNet's uncertainty-driven variable range: per-pixel
    hypotheses spaced uniformly in mean +- gamma*std of the stage-1
    distribution (gamma learned, initialised to 1.5). `pcwnet` fuses a 1/16
    volume into stage 1 and refines it with a warping volume over offsets
    -4..4.
    """

    def __init__(self, max_disparity: int = 192, base_features: int = 32, num_groups: int = 8,
                 concat_features: int = 12, refine_offsets: int = 8, variant: str = "cfnet",
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in ("cfnet", "pcwnet"):
            raise ValueError(f"unknown stereo variant {variant!r}")
        f, g, dt = base_features, generator, dtype
        self.max_disparity, self.num_groups = max_disparity, num_groups
        self.concat_features, self.refine_offsets, self.variant = (
            concat_features, refine_offsets, variant)
        self.features = UNetFeatures(f, generator=g, dtype=dt)
        vol_features = num_groups + 2 * concat_features
        names = {"UNetFeatures_0": "features"}
        stages = ["stage1"]
        if variant == "pcwnet":
            self.agg16 = Conv3dBlock(vol_features, f, generator=g, dtype=dt)
            names["Conv3dBlock_0"] = "agg16"
            vol_features += f
            self.warp_stage = CostVolumeStage(num_groups, f // 2, num_hourglasses=1, generator=g,
                                              dtype=dt)
            stages.append("warp_stage")
        self.stage1 = CostVolumeStage(vol_features, f, generator=g, dtype=dt)
        self.stage2 = CostVolumeStage(num_groups, f // 2, num_hourglasses=1, generator=g,
                                      dtype=dt)
        stages.append("stage2")
        names.update({f"CostVolumeStage_{i}": name for i, name in enumerate(stages)})
        self.flax_names = names
        self.range_gamma = nn.Parameter(torch.tensor(1.5))

    def forward(self, left, right):
        """left/right: [N, H, W, 3] in [0, 1]. Returns a dict of outputs:

        disparity [N, H, W] at full resolution; confidence [N, H, W] in
        [0, 1]; disparity_1_4, disparity_1_8 and uncertainty_1_8 for deep
        supervision.
        """
        height, width = left.shape[1:3]
        l4, l8, l16 = self.features(_nchw(left))
        r4, r8, r16 = self.features(_nchw(right))
        G, Cc = self.num_groups, self.concat_features

        # ---- Stage 1: full range at 1/8.
        d8 = self.max_disparity // 8
        vol8 = _cost_volume_nchw(l8, r8, d8, G, Cc)
        if self.variant == "pcwnet":
            vol16 = _cost_volume_nchw(l16, r16, self.max_disparity // 16, G, Cc)
            agg16 = resize(self.agg16(vol16), vol8.shape[2:])
            vol8 = torch.cat([vol8, agg16], dim=1)
        disp_values8 = torch.arange(d8, dtype=torch.float32, device=left.device)
        disp8, var8 = disparity_regression(self.stage1(vol8), disp_values8)

        if self.variant == "pcwnet":
            # PCWNet's warping volume: re-warp the right features by the
            # stage-1 disparity and regress a residual over offsets -4..4.
            r8_warp = _warp_nchw(r8, disp8)
            offsets = range(-4, 5)
            wvol = torch.stack([_gwc_nchw(l8, _shift_nchw(r8_warp, o), G) for o in offsets], dim=2)
            woffs = torch.arange(-4, 5, dtype=torch.float32, device=left.device)
            resid8, var8 = disparity_regression(self.warp_stage(wvol), woffs)
            disp8 = F.relu(disp8 + resid8)

        # ---- Stage 2: uncertainty-driven variable disparity range at 1/4.
        std8 = torch.sqrt(var8 + 1e-6)
        half8 = torch.clamp(torch.abs(self.range_gamma) * std8, 1.0, float(d8))
        size4 = l4.shape[2:]
        disp4_init = 2.0 * up(disp8[:, None])[:, 0, : size4[0], : size4[1]]
        half4 = 2.0 * up(half8[:, None])[:, 0, : size4[0], : size4[1]]
        n_hyp = 2 * self.refine_offsets + 1
        fracs = torch.linspace(-1.0, 1.0, n_hyp, device=left.device)
        hyps = disp4_init[:, None] + fracs[None, :, None, None] * half4[:, None]
        hyps = torch.clamp(hyps, 0.0, self.max_disparity / 4.0)
        vol4 = torch.stack([_gwc_nchw(l4, _warp_nchw(r4, hyps[:, i]), G)
                            for i in range(n_hyp)], dim=2)
        disp4, var4 = disparity_regression(self.stage2(vol4), hyps)

        # ---- Full-resolution output; low variance -> high confidence.
        disparity = 4.0 * up(disp4[:, None], 4)[:, 0, :height, :width]
        confidence = up(torch.exp(-var4)[:, None], 4)[:, 0, :height, :width]
        return {
            "disparity": disparity,
            "confidence": confidence,
            "disparity_1_4": disp4,
            "disparity_1_8": disp8,
            "uncertainty_1_8": var8,
        }


def multi_scale_loss(outputs, disp_gt, max_disparity: float, weights=(0.5, 0.7, 1.0)):
    """Weighted smooth-L1 over the scale pyramid, masked to valid in-range
    ground truth [N, H, W]."""
    m = ((disp_gt > 0) & (disp_gt < max_disparity)).float()
    denom = torch.clamp(m.sum(), min=1.0)

    def masked_smooth_l1(pred):
        if pred.shape != disp_gt.shape:
            scale = disp_gt.shape[-1] // pred.shape[-1]
            pred = scale * up(pred[:, None], scale)[:, 0, : disp_gt.shape[1], : disp_gt.shape[2]]
        err = pred - disp_gt
        abs_err = torch.abs(err)
        val = torch.where(abs_err < 1.0, 0.5 * err**2, abs_err - 0.5)
        return (m * val).sum() / denom

    preds = [outputs["disparity_1_8"], outputs["disparity_1_4"], outputs["disparity"]]
    return sum(w * masked_smooth_l1(p) for w, p in zip(weights, preds))


def disparity_to_depth(disp, focal: float, baseline: float, min_disp: float = 0.1):
    """depth = f * B / disparity; invalid (tiny) disparities -> 0."""
    # A tensor numerator: `scalar / tensor` would multiply by a reciprocal.
    fb = torch.tensor(focal * baseline, dtype=disp.dtype, device=disp.device)
    depth = fb / torch.clamp(disp, min=min_disp)
    return torch.where(disp > min_disp, depth, torch.zeros_like(depth))
