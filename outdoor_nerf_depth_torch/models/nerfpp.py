"""Inverted-sphere foreground/background model with a sampling cascade (NeRF++).

Port of `InvertedSphereModel` from the reference package's
`models/nerfpp.py`: a foreground volume inside the unit sphere and a
background parametrized on the inverted sphere (x', y', z', 1/r),
composited through the foreground's exit transmittance `bg_lambda`. Level 0
samples both evenly (stratified under a generator); each later level draws
new samples from the previous level's weights by inverse CDF and merges
them with the old ones. Every level has its own fg and bg `PointFieldMLP`.
An optional per-image autoexposure (scale, shift) embedding rides along.

Compositing is `cumprod(1 - alpha + 1e-6)` in plain torch, as in the
reference (no compositing kernel: its numerics differ from K1's
exp-of-cumsum by the 1e-6 term). Randomness comes from the `generator`
passed to `forward`; `generator=None` is the deterministic path. Module
names follow the Flax tree: `level{i}.{fg,bg}_field` and `autoexpo{i}`.

Under a profiler each level marks its draw (`nerfpp.sample`) and its
foreground and background (`nerfpp.fg`, `nerfpp.bg`: points, field MLP and
compositing), and a forward counts its field points (`nerfpp.points`, fg
plus bg) and rays (`nerfpp.rays`) from the shapes (`utils/tracing.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from outdoor_nerf_depth_torch.models.mlps import PointFieldMLP
from outdoor_nerf_depth_torch.ops import geometry, mathx, stepfuns
from outdoor_nerf_depth_torch.parallel import mesh
from outdoor_nerf_depth_torch.utils import tracing

_HUGE = 1e10
_TINY = 1e-6


class SphereSceneLevel(nn.Module):
    """One cascade level: fg and bg fields, rendered and composited."""

    def __init__(self, generator: Optional[torch.Generator] = None, **field_params):
        super().__init__()
        self.fg_field = PointFieldMLP(input_dim=3, generator=generator, **field_params)
        self.bg_field = PointFieldMLP(input_dim=4, generator=generator, **field_params)

    def forward(self, ray_o, ray_d, fg_far, fg_z, bg_inv_r):
        """Render one level.

        ray_o, ray_d [..., 3] (origins inside the unit sphere); fg_far [...]
        the distance to the sphere exit; fg_z [..., Sf] sorted fg samples;
        bg_inv_r [..., Sb] ascending inverse radii in (0, 1]. Returns the
        render dict with the per-sample arrays for resampling and losses.
        """
        d_norm = torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        viewdirs = ray_d / d_norm

        with tracing.span("nerfpp.fg"):
            # Foreground: points inside the unit sphere, per-ray view directions.
            fg_pts = ray_o[..., None, :] + fg_z[..., None] * ray_d[..., None, :]
            fg_sigma, fg_rgb = self.fg_field(fg_pts, viewdirs)
            # Sample to sample, then on to the sphere exit; metric by |d|.
            fg_len = d_norm * torch.cat(
                [torch.diff(fg_z, dim=-1), fg_far[..., None] - fg_z[..., -1:]], dim=-1
            )
            fg_alpha = 1.0 - torch.exp(-fg_sigma * fg_len)
            surv = torch.cumprod(1.0 - fg_alpha + _TINY, dim=-1)
            bg_lambda = surv[..., -1]  # transmittance past the sphere
            fg_trans = torch.cat([torch.ones_like(surv[..., :1]), surv[..., :-1]], dim=-1)
            fg_weights = fg_alpha * fg_trans
            fg_rgb_map = torch.sum(fg_weights[..., None] * fg_rgb, dim=-2)
            fg_depth_map = torch.sum(fg_weights * fg_z, dim=-1)

        with tracing.span("nerfpp.bg"):
            # Background: march the shells near to far, i.e. in descending
            # inverse radius from the sphere outward.
            inv_r_nf = torch.flip(bg_inv_r, dims=(-1,))
            shape = bg_inv_r.shape + (3,)
            bg_pts, bg_t = geometry.inverted_sphere_points(
                ray_o[..., None, :].expand(shape), ray_d[..., None, :].expand(shape), inv_r_nf
            )
            bg_sigma, bg_rgb = self.bg_field(bg_pts, viewdirs)
            # Shell widths in inverse radius; the outermost reaches infinity.
            bg_len = torch.cat(
                [inv_r_nf[..., :-1] - inv_r_nf[..., 1:], torch.full_like(inv_r_nf[..., :1], _HUGE)],
                dim=-1,
            )
            bg_alpha = 1.0 - torch.exp(-bg_sigma * bg_len)
            bg_surv = torch.cumprod(1.0 - bg_alpha + _TINY, dim=-1)[..., :-1]
            bg_trans = torch.cat([torch.ones_like(bg_surv[..., :1]), bg_surv], dim=-1)
            bg_weights = bg_alpha * bg_trans
            bg_rgb_map = torch.sum(bg_weights[..., None] * bg_rgb, dim=-2)
            bg_depth_map = torch.sum(bg_weights * bg_t, dim=-1)

        depth = fg_depth_map + bg_lambda * bg_depth_map
        return dict(
            rgb=fg_rgb_map + bg_lambda[..., None] * bg_rgb_map,
            depth=depth,
            distance_mean=depth,
            fg_rgb=fg_rgb_map,
            fg_depth=fg_depth_map,
            bg_rgb=bg_lambda[..., None] * bg_rgb_map,
            bg_depth=bg_lambda * bg_depth_map,
            bg_lambda=bg_lambda,
            acc=torch.sum(fg_weights, dim=-1) + bg_lambda * torch.sum(bg_weights, dim=-1),
            fg_weights=fg_weights,
            # Back in ascending inv_r order, aligned with `bg_inv_r`'s bins.
            bg_weights=torch.flip(bg_weights, dims=(-1,)),
            fg_len=fg_len,
            steps=fg_z,
        )


class InvertedSphereModel(nn.Module):
    """NeRF++: an evenly sampled level, then inverse-CDF resampled levels."""

    def __init__(
        self,
        cascade_samples: Tuple[int, ...] = (64, 128),
        net_depth: int = 8,
        net_width: int = 256,
        pos_degrees: int = 10,
        view_degrees: int = 4,
        optimize_autoexposure: bool = False,
        num_images: int = 256,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cascade_samples = tuple(cascade_samples)
        self.optimize_autoexposure = optimize_autoexposure
        field = dict(net_depth=net_depth, net_width=net_width, pos_degrees=pos_degrees,
                     view_degrees=view_degrees, compute_dtype=compute_dtype)
        for level in range(len(self.cascade_samples)):
            self.add_module(f"level{level}", SphereSceneLevel(generator=generator, **field))
        if optimize_autoexposure:
            for level in range(len(self.cascade_samples)):
                init = torch.tensor([0.5, 0.0]).repeat(num_images, 1)  # scale 1, shift 0
                self.add_module(f"autoexpo{level}",
                                nn.Embedding.from_pretrained(init, freeze=False))

    def forward(
        self,
        rays,
        train_frac: float = 1.0,
        compute_extras: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Render `rays` (a `data.rays.Rays` of tensors on one device); the
        per-ray near bound is `rays.near`. Returns (renderings, ray_history),
        one dict per level, finest last."""
        del train_frac, compute_extras
        ray_o, ray_d = rays.origins, rays.directions
        fg_far, _ = geometry.intersect_unit_sphere(ray_o, ray_d)
        fg_near = rays.near[..., 0].expand(fg_far.shape)
        tracing.count("nerfpp.rays", fg_far.numel())

        renderings, ray_history = [], []
        fg_z = bg_inv_r = prev = None
        for level, n_samples in enumerate(self.cascade_samples):
            # No parameter reaches the samples: draw them without a graph.
            with tracing.span("nerfpp.sample"), torch.no_grad():
                if level == 0:
                    frac = torch.linspace(0.0, 1.0, n_samples, dtype=ray_o.dtype,
                                          device=ray_o.device)
                    fg_z = fg_near[..., None] + (fg_far - fg_near)[..., None] * frac
                    bg_inv_r = frac.expand(fg_z.shape)
                    if generator is not None:
                        fg_z = _jitter_points(generator, fg_z)
                        bg_inv_r = _jitter_points(generator, bg_inv_r)
                else:
                    fg_new = _sample_from_weights(generator, prev["fg_weights"], fg_z, n_samples)
                    fg_z = torch.sort(torch.cat([fg_z, fg_new], dim=-1), dim=-1).values
                    bg_new = _sample_from_weights(generator, prev["bg_weights"], bg_inv_r,
                                                  n_samples)
                    bg_inv_r = torch.sort(torch.cat([bg_inv_r, bg_new], dim=-1), dim=-1).values

            tracing.count("nerfpp.points", fg_z.numel() + bg_inv_r.numel())
            out = getattr(self, f"level{level}")(ray_o, ray_d, fg_far, fg_z, bg_inv_r)
            if self.optimize_autoexposure:
                expo = getattr(self, f"autoexpo{level}")(rays.cam_idx[..., 0].long())
                out["autoexpo_scale"] = mathx.abs_(expo[..., :1]) + 0.5
                out["autoexpo_shift"] = expo[..., 1:]
            prev = out
            renderings.append(out)
            ray_history.append(dict(weights=out["fg_weights"], steps=fg_z,
                                    lengths=out["fg_len"], fg_far=fg_far))
        return renderings, ray_history


def _jitter_points(generator: torch.Generator, z: torch.Tensor) -> torch.Tensor:
    """Stratified jitter of point samples within their mid-to-mid cells."""
    mid = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mid, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mid], dim=-1)
    u = mesh.rand(z.shape, generator=generator, dtype=z.dtype, device=z.device)
    return lower + (upper - lower) * u


def _sample_from_weights(generator: Optional[torch.Generator], weights, z, n_samples: int):
    """New points from the histogram over the midpoints of the samples `z`;
    the two end samples' weights are dropped."""
    bins = 0.5 * (z[..., 1:] + z[..., :-1])
    logits = torch.log(weights[..., 1:-1] + 1e-8)
    return stepfuns.sample(generator, bins, logits, n_samples)
