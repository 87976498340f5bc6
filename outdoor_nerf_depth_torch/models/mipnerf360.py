"""Hierarchical proposal-sampling cone-tracing model (mip-NeRF 360 family).

Port of `ProposalModel` from the reference package's `models/mipnerf360.py`:
per level, weight dilation, Schlick annealing, interval resampling in
normalized s-space, the s->t warp, cone->Gaussian casting, the field MLP,
compositing weights (CUDA kernel K1 on the GPU) and the volumetric render.

Randomness (the per-level stratified jitter, the field MLPs' density and
bottleneck noise, and a random background) comes from the `generator`
passed to `forward`; `generator=None` is the deterministic path.

Per-image appearance: a GLO embedding (`glo`, `num_glo_features` wide) whose
row for the ray's camera joins the nerf MLP's view input, and learned
exposure scaling (`exposure_scaling`, three offsets per camera, starting at
zero) that multiplies the rendered colour by 1 + offset. Both are used only
with `zero_glo=False`, as in training; `zero_glo=True` (the default, for
evaluation on cameras the embeddings never saw) feeds the nerf MLP a zero
GLO vector and scales nothing. Unlike the reference's `init_state`, which
initializes the model with `zero_glo=True` and so never creates these
embeddings, the port's model owns them from construction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from outdoor_nerf_depth_torch.models.mlps import ConeFieldMLP
from outdoor_nerf_depth_torch.ops import spaces, stepfuns, volren
from outdoor_nerf_depth_torch.parallel import mesh


class ProposalModel(nn.Module):
    """N-level proposal hierarchy: (num_levels - 1) prop passes + 1 nerf pass."""

    def __init__(
        self,
        num_prop_samples: int = 64,
        num_nerf_samples: int = 32,
        num_levels: int = 3,
        anneal_slope: float = 10.0,
        stop_level_grad: bool = True,
        use_viewdirs: bool = True,
        raydist_fn: Optional[str] = "reciprocal",
        ray_shape: str = "cone",
        disable_integration: bool = False,
        single_jitter: bool = True,
        dilation_multiplier: float = 0.5,
        dilation_bias: float = 0.0025,
        near_anneal_rate: Optional[float] = None,
        near_anneal_init: float = 0.95,
        single_mlp: bool = False,
        resample_padding: float = 0.0,
        use_gather_resampling: bool = False,
        opaque_background: bool = False,
        bg_intensity_range: Tuple[float, float] = (1.0, 1.0),
        num_glo_features: int = 0,
        num_glo_embeddings: int = 1000,
        learned_exposure_scaling: bool = False,
        vis_num_rays: int = 16,
        nerf_mlp_params=None,
        prop_mlp_params=None,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del use_gather_resampling  # the port resamples through one searchsorted path
        self.num_prop_samples = num_prop_samples
        self.num_nerf_samples = num_nerf_samples
        self.num_levels = num_levels
        self.anneal_slope = anneal_slope
        self.stop_level_grad = stop_level_grad
        self.use_viewdirs = use_viewdirs
        self.raydist_fn = raydist_fn
        self.ray_shape = ray_shape
        self.disable_integration = disable_integration
        self.single_jitter = single_jitter
        self.dilation_multiplier = dilation_multiplier
        self.dilation_bias = dilation_bias
        self.near_anneal_rate = near_anneal_rate
        self.near_anneal_init = near_anneal_init
        self.resample_padding = resample_padding
        self.opaque_background = opaque_background
        self.bg_intensity_range = tuple(bg_intensity_range)
        self.num_glo_features = num_glo_features
        self.learned_exposure_scaling = learned_exposure_scaling
        self.vis_num_rays = vis_num_rays

        common = dict(warp="contract", use_viewdirs=use_viewdirs,
                      compute_dtype=compute_dtype, generator=generator)
        self.nerf_mlp = ConeFieldMLP(num_glo_features=num_glo_features, **common,
                                     **(nerf_mlp_params or {}))
        self.prop_mlp = (
            self.nerf_mlp if single_mlp
            else ConeFieldMLP(disable_rgb=True, **common, **(prop_mlp_params or {}))
        )
        if num_glo_features > 0:
            # Flax `Embed`'s default init: N(0, 1 / features).
            self.glo = nn.Embedding(num_glo_embeddings, num_glo_features)
            nn.init.normal_(self.glo.weight, std=num_glo_features**-0.5, generator=generator)
        if learned_exposure_scaling:
            self.exposure_scaling = nn.Embedding(num_glo_embeddings, 3)
            nn.init.zeros_(self.exposure_scaling.weight)

    def forward(
        self,
        rays,
        train_frac: float = 1.0,
        compute_extras: bool = False,
        generator: Optional[torch.Generator] = None,
        zero_glo: bool = True,
    ):
        """Render `rays` (a `data.rays.Rays` of tensors on one device).

        Returns (renderings, ray_history): one dict per level, finest last.
        With `compute_extras` each rendering also holds the composited
        normals and roughness the fields give, and `ray_sdist`,
        `ray_weights` and `ray_rgbs` of the first `vis_num_rays` rays (the
        proposal levels' colours are the final level's composited colour).
        `zero_glo=False` uses the GLO and exposure embeddings of the rays'
        cameras.
        """
        cam_idx = rays.cam_idx[..., 0].long()
        glo_vec = None
        if self.num_glo_features > 0:
            glo_vec = (torch.zeros(rays.origins.shape[:-1] + (self.num_glo_features,),
                                   dtype=torch.float32, device=rays.origins.device)
                       if zero_glo else self.glo(cam_idx))
        exposure_scale = None
        if self.learned_exposure_scaling and not zero_glo:
            exposure_scale = 1.0 + self.exposure_scaling(cam_idx)
        _, s_to_t = spaces.metric_to_normalized(self.raydist_fn, rays.near, rays.far)
        if self.near_anneal_rate is None:
            s_near = 0.0
        else:
            s_near = min(max(1.0 - train_frac / self.near_anneal_rate, 0.0), self.near_anneal_init)
        s_far = 1.0

        sdist = torch.cat(
            [torch.full_like(rays.near, s_near), torch.full_like(rays.far, s_far)], dim=-1
        )
        weights = torch.ones_like(rays.near)
        prod_num_samples = 1

        renderings, ray_history = [], []
        for level in range(self.num_levels):
            is_prop = level < self.num_levels - 1
            num_samples = self.num_prop_samples if is_prop else self.num_nerf_samples
            dilation = (
                self.dilation_bias
                + self.dilation_multiplier * (s_far - s_near) / prod_num_samples
            )
            prod_num_samples *= num_samples

            # With stop_level_grad no gradient reaches the resampled edges,
            # so resampling runs without building a graph.
            with torch.set_grad_enabled(torch.is_grad_enabled() and not self.stop_level_grad):
                if level > 0 and (self.dilation_bias > 0 or self.dilation_multiplier > 0):
                    sdist, weights = stepfuns.max_dilate_weights(
                        sdist, weights, dilation, domain=(s_near, s_far), renormalize=True
                    )
                    sdist = sdist[..., 1:-1]
                    weights = weights[..., 1:-1]
                if self.anneal_slope > 0:
                    # Schlick bias ramp on the resampling sharpness.
                    anneal = (self.anneal_slope * train_frac) / (
                        (self.anneal_slope - 1.0) * train_frac + 1.0
                    )
                else:
                    anneal = 1.0
                logits = torch.where(
                    sdist[..., 1:] > sdist[..., :-1],
                    anneal * torch.log(weights + self.resample_padding),
                    torch.full((), float("-inf"), dtype=weights.dtype, device=weights.device),
                )
                sdist = stepfuns.sample_intervals(
                    generator, sdist, logits, num_samples,
                    single_jitter=self.single_jitter, domain=(s_near, s_far),
                )
            if self.stop_level_grad:
                sdist = sdist.detach()

            tdist = s_to_t(sdist)
            means, covs = volren.cast_rays(
                tdist, rays.origins, rays.directions, rays.radii,
                ray_shape=self.ray_shape, diagonal=False,
            )
            if self.disable_integration:
                covs = torch.zeros_like(covs)

            mlp = self.prop_mlp if is_prop else self.nerf_mlp
            field = mlp(means, covs, viewdirs=rays.viewdirs if self.use_viewdirs else None,
                        glo_vec=None if is_prop else glo_vec, generator=generator)
            weights = volren.composite_weights(
                field["density"], tdist, rays.directions,
                opaque_background=self.opaque_background,
            )

            lo, hi = self.bg_intensity_range
            if lo == hi:
                bg_rgbs = lo
            elif generator is None:
                bg_rgbs = 0.5 * (lo + hi)
            else:
                bg_rgbs = lo + (hi - lo) * mesh.rand(
                    weights.shape[:-1] + (3,), generator=generator,
                    dtype=weights.dtype, device=weights.device,
                )

            rendering = volren.composite(
                field["rgb"], weights, tdist, bg_rgbs, rays.far, compute_extras,
                extras={k: field[k] for k in ("normals", "normals_pred", "roughness")},
            )
            if rays.exposure_values is not None:
                rendering["rgb"] = rendering["rgb"] * rays.exposure_values
            if exposure_scale is not None:
                rendering["rgb"] = rendering["rgb"] * exposure_scale
            if compute_extras:
                n = self.vis_num_rays
                rendering["ray_sdist"] = sdist.reshape(-1, sdist.shape[-1])[:n]
                rendering["ray_weights"] = weights.reshape(-1, weights.shape[-1])[:n]
                rendering["ray_rgbs"] = field["rgb"].reshape((-1,) + field["rgb"].shape[-2:])[:n]
            renderings.append(rendering)
            ray_history.append(
                dict(sdist=sdist, tdist=tdist, weights=weights, density=field["density"],
                     normals=field["normals"], normals_pred=field["normals_pred"])
            )
        if compute_extras:
            # The proposal levels have no colour: show the final level's.
            final = renderings[-1]
            final_rgb = torch.sum(final["ray_rgbs"] * final["ray_weights"][..., None], dim=-2)
            for r in renderings[:-1]:
                r["ray_rgbs"] = final_rgb[:, None, :].expand(r["ray_rgbs"].shape)
        return renderings, ray_history
