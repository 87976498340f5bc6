"""Instant-NGP: hash-grid field and occupancy-grid marching renderer.

Port of `HashGridField` and `HashGridModel` from the reference package's
`models/ngp.py`. The train path: AABB clip, fixed-width candidate
marching, occupancy lookup, compaction of the occupied candidates, the
optional batch-wide `sample_budget` compaction, the field (hash encoding,
truncated-exp density, degree-4 SH view encoding, sigmoid rgb), compositing
weights (CUDA kernel K1 on the GPU) and the render. The iterative eval
renderer (`HashGridModel.render_eval`): rounds of occupied candidates
spaced by `calc_dt`, composited with a carried transmittance until every
ray is opaque or out of the scene. With a bfloat16 `compute_dtype` the
MLPs run in bfloat16 and density and rgb return to float32 before their
activations, as in the reference.

Two options of the reference's `ngp-depth`: the HDR field
(`rgb_activation="none"`), whose rgb net emits log-radiance that three
per-channel tonemapper nets map, with the ray's log-exposure added, to LDR
colour (`output_radiance=True` renders the radiance itself); and per-image
extrinsics refinement (`optimize_ext`): zero-initialised rotation
(axis-angle) and translation deltas per camera index, `pose_dR` and
`pose_dT`, applied to every ray before marching.

The occupancy grid is a buffer of the model (`occupancy`), so `.to()` and
copies carry it; `forward` takes the grid as an explicit argument, as in the
reference (`occupancy=None` marches densely). The train step and the
renderer pass the buffer. Layer names match the Flax modules:
`field.encoder.table`, `field.sigma_hidden`, `field.sigma_out`,
`field.rgb_hidden{i}`, `field.rgb_out`, `field.tonemap_hidden{i}`,
`field.tonemap_out{i}`, `pose_dR`, `pose_dT`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from outdoor_nerf_depth_torch.models.mlps import _dense
from outdoor_nerf_depth_torch.ops import hashgrid, mathx, volren
from outdoor_nerf_depth_torch.ops import occupancy as occ
from outdoor_nerf_depth_torch.parallel import mesh


class HashGridField(nn.Module):
    """Hash encoding -> density and geometry features; SH + features -> rgb."""

    def __init__(
        self,
        scale: float = 0.5,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_resolution: int = 16,
        max_resolution: int = 0,  # 0: 2048 * (2 * scale)
        geo_features: int = 15,
        hidden_width: int = 64,
        rgb_hidden_layers: int = 2,
        rgb_activation: str = "sigmoid",
        tonemap_width: int = 64,
        hash_layout: str = "osplit",
        grad_mode: str = "auto",
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if rgb_activation not in ("sigmoid", "none"):
            raise ValueError(f"rgb_activation={rgb_activation!r}: expected 'sigmoid' or 'none'")
        self.hdr = rgb_activation == "none"
        max_res = max_resolution or max(int(2048 * 2 * scale), base_resolution + 1)
        self.encoder = hashgrid.HashGridEncoding(
            n_levels=n_levels, n_features=n_features, log2_table_size=log2_table_size,
            base_resolution=base_resolution, max_resolution=max_res, layout=hash_layout,
            grad_mode=grad_mode, compute_dtype=compute_dtype, generator=generator,
        )
        self.e_max = float(occ.cascade_extents(scale)[-1])
        self.compute_dtype = dtype = mathx.as_dtype(compute_dtype)
        self.sigma_hidden = _dense(self.encoder.out_dim, hidden_width, generator,
                                   compute_dtype=dtype)
        self.sigma_out = _dense(hidden_width, 1 + geo_features, generator, compute_dtype=dtype)
        y_dim = 16 + geo_features  # SH degree 4 + geometry features
        self.rgb_names = []
        for i in range(rgb_hidden_layers):
            self.add_module(f"rgb_hidden{i}",
                            _dense(y_dim, hidden_width, generator, compute_dtype=dtype))
            self.rgb_names.append(f"rgb_hidden{i}")
            y_dim = hidden_width
        self.rgb_out = _dense(y_dim, 3, generator, compute_dtype=dtype)
        if self.hdr:
            for i in range(3):
                self.add_module(f"tonemap_hidden{i}",
                                _dense(1, tonemap_width, generator, compute_dtype=dtype))
                self.add_module(f"tonemap_out{i}",
                                _dense(tonemap_width, 1, generator, compute_dtype=dtype))

    def density(self, x, prepared=None):
        """sigma [...], geometry features [..., geo_features] of world points."""
        # The world cube [-e_max, e_max]^3 of the outermost cascade -> unit cube.
        enc = self.encoder(x / (2.0 * self.e_max) + 0.5, prepared=prepared)
        h = self.sigma_out(F.relu(self.sigma_hidden(enc))).to(torch.float32)
        return hashgrid.truncated_exp(h[..., 0]), h[..., 1:]

    def tonemap(self, log_radiance, exposure=None):
        """Per-channel learned tonemapping of log-radiance plus log-exposure."""
        log_expo = 0.0 if exposure is None else torch.log(exposure)
        chans = []
        for i in range(3):
            inp = (log_radiance[..., i:i + 1] + log_expo).to(self.compute_dtype)
            h = F.relu(getattr(self, f"tonemap_hidden{i}")(inp))
            chans.append(torch.sigmoid(getattr(self, f"tonemap_out{i}")(h).to(torch.float32)))
        return torch.cat(chans, dim=-1)

    def forward(self, x, viewdirs, exposure=None, output_radiance: bool = False, prepared=None):
        """x [..., 3] world points, viewdirs [..., 3] unit -> (sigma, rgb).

        An HDR field returns the radiance itself with `output_radiance`,
        else its tonemapped colour under `exposure` (broadcast against
        [..., 1]; None: exposure 1)."""
        sigma, feats = self.density(x, prepared=prepared)
        sh = hashgrid.spherical_harmonics(viewdirs)
        y = torch.cat([sh.expand(feats.shape[:-1] + sh.shape[-1:]), feats], dim=-1)
        y = y.to(self.compute_dtype)
        for name in self.rgb_names:
            y = F.relu(getattr(self, name)(y))
        out = self.rgb_out(y).to(torch.float32)
        if not self.hdr:
            return sigma, torch.sigmoid(out)
        if output_radiance:
            return sigma, hashgrid.truncated_exp(out)
        return sigma, self.tonemap(out, exposure)


class HashGridModel(nn.Module):
    """AABB clip -> masked marching -> field -> composite."""

    def __init__(
        self,
        scale: float = 0.5,
        grid_resolution: int = 128,
        max_samples: int = 128,
        n_candidates: int = 512,
        sample_budget: int = 0,
        exponential_steps: Optional[bool] = None,
        near_distance: float = 0.01,
        density_threshold: float = 0.01,
        bg_intensity_range: Tuple[float, float] = (0.0, 0.0),
        eval_samples_per_round: int = 32,
        eval_candidates_per_round: int = 256,
        eval_early_stop_eps: float = 1e-4,
        eval_max_total_samples: int = 1024,
        output_radiance: bool = False,
        optimize_ext: bool = False,
        num_images: int = 1000,
        hash_layout: str = "osplit",
        field_params=None,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.scale = scale
        self.grid_resolution = grid_resolution
        self.max_samples = max_samples
        self.n_candidates = n_candidates
        self.sample_budget = sample_budget
        self.exponential = scale > 0.5 if exponential_steps is None else exponential_steps
        self.near_distance = near_distance
        self.density_threshold = density_threshold
        self.bg_intensity_range = tuple(bg_intensity_range)
        self.eval_samples_per_round = eval_samples_per_round
        self.eval_candidates_per_round = eval_candidates_per_round
        self.eval_early_stop_eps = eval_early_stop_eps
        self.eval_max_total_samples = eval_max_total_samples
        # With a sigmoid field `output_radiance` changes nothing.
        self.output_radiance = output_radiance
        self.optimize_ext = optimize_ext
        field_kwargs = dict(field_params or {})
        field_kwargs.setdefault("hash_layout", hash_layout)
        # An explicit field_params["hash_layout"] wins; checkpoints record it.
        self.effective_hash_layout = field_kwargs["hash_layout"]
        self.field = HashGridField(scale=scale, compute_dtype=compute_dtype,
                                   generator=generator, **field_kwargs)
        self.e_max = self.field.e_max
        self.register_buffer("occupancy", occ.init_grid(scale, grid_resolution))
        if optimize_ext:
            self.pose_dR = nn.Embedding(num_images, 3)
            self.pose_dT = nn.Embedding(num_images, 3)
            nn.init.zeros_(self.pose_dR.weight)
            nn.init.zeros_(self.pose_dT.weight)

    def refine_rays(self, rays):
        """Rays under each camera's learned SE(3) delta: directions and
        viewdirs rotated by Rodrigues' formula about dR[cam] (viewdirs
        renormalised), origins moved by dT[cam]. Unchanged without
        `optimize_ext`."""
        if not self.optimize_ext:
            return rays
        idx = rays.cam_idx[..., 0].to(torch.int64)
        dr, dt = self.pose_dR(idx), self.pose_dT(idx)
        # The 1e-12 keeps axis = dr / theta finite (0) at dr = 0, where the
        # deltas start; its gradient there is that of the rotation's first order.
        theta = torch.sqrt(torch.sum(dr**2, dim=-1, keepdim=True) + 1e-12)
        axis = dr / theta
        cos, sin = torch.cos(theta), torch.sin(theta)

        def rot(v):
            return (v * cos + torch.linalg.cross(axis, v) * sin
                    + axis * torch.sum(axis * v, dim=-1, keepdim=True) * (1.0 - cos))

        viewdirs = rot(rays.viewdirs)
        return dataclasses.replace(
            rays, origins=rays.origins + dt, directions=rot(rays.directions),
            viewdirs=viewdirs / torch.linalg.norm(viewdirs, dim=-1, keepdim=True))

    def density(self, x, prepared=None):
        """Raw density, for occupancy-grid refreshes."""
        return self.field.density(x, prepared=prepared)[0]

    def prepare_tables(self):
        """The packed hash tables, built once for a sweep of frozen weights."""
        return self.field.encoder.prepare()

    def forward(
        self,
        rays,
        train_frac: float = 1.0,
        compute_extras: bool = False,
        generator: Optional[torch.Generator] = None,
        occupancy: Optional[torch.Tensor] = None,
    ):
        """Render `rays`; returns ([rendering], [history]) like every model.

        `generator` jitters the candidates (None: deterministic); `occupancy`
        is the [cascades, R^3] density grid to march through (None: every
        candidate is occupied).
        """
        del train_frac, compute_extras
        rays = self.refine_rays(rays)
        exposure = rays.exposure_values
        # March along unit directions, so t is metric distance.
        t_near, t_far, hit = occ.intersect_aabb(
            rays.origins, rays.viewdirs, self.e_max, near_min=self.near_distance
        )
        t_near = torch.maximum(t_near, rays.near[..., 0])
        t_far = torch.maximum(torch.minimum(t_far, rays.far[..., 0]), t_near + 1e-4)
        edges = occ.march_candidates(generator, t_near, t_far, self.n_candidates, self.exponential)
        if occupancy is not None:
            mids_all = 0.5 * (edges[..., :-1] + edges[..., 1:])
            pts_all = rays.origins[..., None, :] + mids_all[..., None] * rays.viewdirs[..., None, :]
            # min(threshold, mean density) keeps marching alive while the
            # whole field is still dim.
            thresh = torch.clamp(occ.mean_density(occupancy), max=self.density_threshold)
            occupied = occ.lookup(occupancy, pts_all, self.scale, thresh)
        else:
            occupied = torch.ones(edges.shape[:-1] + (self.n_candidates,), dtype=torch.bool,
                                  device=edges.device)
        occupied = occupied & hit[..., None]

        t_mid, dt, valid = occ.compact_occupied(edges, occupied, self.max_samples)
        pts = rays.origins[..., None, :] + t_mid[..., None] * rays.viewdirs[..., None, :]
        # Dead slots all read one constant point; their output is masked.
        pts = torch.where(valid[..., None], pts, 0.0)
        if self.sample_budget and self.sample_budget < self.max_samples:
            # Run the field only on the valid slots (up to the budget), then
            # expand sigma and rgb back onto the dense [rays, K] grid.
            batch_shape, k = valid.shape[:-1], valid.shape[-1]
            n_rays = valid[..., 0].numel()
            budget = n_rays * int(self.sample_budget)
            sel, inv = occ.batch_compaction_plan(valid, budget)
            pts_c = pts.reshape(-1, 3)[sel]
            ray_id = sel // k
            vdirs_c = rays.viewdirs.reshape(-1, 3)[ray_id]
            exp_c = None if exposure is None else exposure.reshape(-1, exposure.shape[-1])[ray_id]
            sigma_c, rgb_c = self.field(pts_c, vdirs_c, exposure=exp_c,
                                        output_radiance=self.output_radiance)
            dense = occ.expand_compacted(torch.cat([sigma_c[:, None], rgb_c], dim=-1), inv, sel)
            sigma = dense[:, 0].reshape(batch_shape + (k,))
            rgb = dense[:, 1:].reshape(batch_shape + (k, 3))
        else:
            sigma, rgb = self.field(pts, rays.viewdirs[..., None, :],
                                    exposure=None if exposure is None else exposure[..., None, :],
                                    output_radiance=self.output_radiance)
        sigma = torch.where(valid, sigma, 0.0)

        weights = volren.weights_from_optical_depth(sigma * dt)
        acc = torch.sum(weights, dim=-1)
        lo, hi = self.bg_intensity_range
        if lo == hi:
            bg = lo
        elif generator is None:
            bg = 0.5 * (lo + hi)
        else:
            bg = lo + (hi - lo) * mesh.rand(acc.shape + (3,), generator=generator,
                                             device=acc.device)
        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2) + (1.0 - acc[..., None]) * bg
        depth = torch.sum(weights * t_mid, dim=-1)
        rendering = {
            "rgb": rgb_map,
            "depth": depth,
            "distance_mean": depth,
            "acc": acc,
            "samples_per_ray": torch.sum(valid, dim=-1),
            # Marching efficiency: occupied candidates (rm) and rendered
            # samples (vr) per ray.
            "rm_per_ray": torch.sum(occupied, dim=-1),
            "vr_per_ray": torch.sum(valid, dim=-1),
        }
        history = dict(weights=weights, steps=t_mid, lengths=dt, valid=valid)
        return [rendering], [history]

    @torch.no_grad()
    def render_eval(self, rays, occupancy: torch.Tensor, max_rounds: Optional[int] = None):
        """The iterative eval renderer: the reference's alive-ray marching loop.

        Each round marches every ray still alive `eval_candidates_per_round`
        steps of `calc_dt`, runs the field on the first
        `eval_samples_per_round` occupied candidates (skipped when a round
        has none), composites them under the transmittance carried from
        earlier rounds, and advances t past the window, or only past the
        last rendered sample when the window held more occupied candidates
        than were rendered. A ray retires once its transmittance drops to
        `eval_early_stop_eps` or it leaves the scene. The loop ends when no
        ray is alive or after `max_rounds` (by default enough to render
        `eval_max_total_samples` through fully occupied windows). Each round
        reads one or two flags back from the device.

        Returns rgb (over the `bg_intensity_range` midpoint), depth,
        distance_mean, acc, samples_per_ray and rounds, per ray.
        """
        rays = self.refine_rays(rays)
        exposure = rays.exposure_values
        if exposure is not None:
            exposure = exposure[..., None, :]
        n_cand, n_samp = self.eval_candidates_per_round, self.eval_samples_per_round
        if max_rounds is None:
            max_rounds = max(4, 2 * self.eval_max_total_samples // n_samp)
        exp_factor = 0.0 if self.scale <= 0.5 else 1.0 / 256.0
        origins, viewdirs = rays.origins, rays.viewdirs
        t_near, t_far, hit = occ.intersect_aabb(origins, viewdirs, self.e_max,
                                                near_min=self.near_distance)
        t_near = torch.maximum(t_near, rays.near[..., 0])
        t_far = torch.maximum(torch.minimum(t_far, rays.far[..., 0]), t_near + 1e-4)
        thresh = torch.clamp(occ.mean_density(occupancy), max=self.density_threshold)

        t, alive = t_near, hit
        trans = torch.ones_like(t_near)
        rgb_acc = torch.zeros(t_near.shape + (3,), device=t_near.device)
        depth, acc = torch.zeros_like(t_near), torch.zeros_like(t_near)
        n_samples = torch.zeros(t_near.shape, dtype=torch.int64, device=t_near.device)
        # The packed tables, built once: the weights are frozen for the render.
        prepared = self.prepare_tables()
        offsets = torch.arange(n_cand + 1, dtype=torch.float32, device=t_near.device)
        rounds = 0
        while rounds < max_rounds and bool(alive.any()):
            # A constant step within a round, growing with t across rounds.
            dt_r = occ.calc_dt(t, exp_factor, self.eval_max_total_samples,
                               self.grid_resolution, self.e_max)
            edges = t[..., None] + offsets * dt_r[..., None]
            mids = 0.5 * (edges[..., :-1] + edges[..., 1:])
            pts = origins[..., None, :] + mids[..., None] * viewdirs[..., None, :]
            occupied = occ.lookup(occupancy, pts, self.scale, thresh)
            occupied &= (mids < t_far[..., None]) & alive[..., None]
            # Without subsampling an over-full window is revisited next round.
            t_mid, dt, valid = occ.compact_occupied(edges, occupied, n_samp, subsample=False)
            if bool(valid.any()):
                sample_pts = origins[..., None, :] + t_mid[..., None] * viewdirs[..., None, :]
                # Dead slots all read one constant point; their output is masked.
                sample_pts = torch.where(valid[..., None], sample_pts, 0.0)
                sigma, rgb = self.field(sample_pts, viewdirs[..., None, :], exposure=exposure,
                                        output_radiance=self.output_radiance, prepared=prepared)
            else:  # pure marching: no field evaluation this round
                sigma = torch.zeros_like(t_mid)
                rgb = torch.zeros(t_mid.shape + (3,), device=t_mid.device)
            tau = torch.where(valid, sigma, 0.0) * dt
            trans_in = torch.exp(-torch.cat(
                [torch.zeros_like(tau[..., :1]), torch.cumsum(tau[..., :-1], dim=-1)], dim=-1))
            w = trans[..., None] * trans_in * (1.0 - torch.exp(-tau))
            new_trans = trans * torch.exp(-torch.sum(tau, dim=-1))
            t_end_valid = torch.amax(torch.where(valid, t_mid + 0.5 * dt, float("-inf")), dim=-1)
            truncated = torch.sum(occupied, dim=-1) > n_samp
            t = torch.where(truncated, torch.maximum(t_end_valid, t), edges[..., -1])
            alive = alive & (new_trans > self.eval_early_stop_eps) & (t < t_far)
            trans = new_trans
            rgb_acc = rgb_acc + torch.sum(w[..., None] * rgb, dim=-2)
            depth = depth + torch.sum(w * t_mid, dim=-1)
            acc = acc + torch.sum(w, dim=-1)
            n_samples = n_samples + torch.sum(valid, dim=-1)
            rounds += 1
        lo, hi = self.bg_intensity_range
        return {
            "rgb": rgb_acc + (1.0 - acc[..., None]) * (0.5 * (lo + hi)),
            "depth": depth,
            "distance_mean": depth,
            "acc": acc,
            "samples_per_ray": n_samples,
            "rounds": torch.full(t_near.shape, rounds, dtype=torch.int64, device=t_near.device),
        }


def make_density_fn(model: HashGridModel, prepared=None):
    """Density closure for `ops.occupancy.update_grid` refreshes."""

    def density_fn(pts):
        return model.density(pts, prepared=prepared)

    return density_fn
