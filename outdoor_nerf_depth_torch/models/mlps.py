"""The field MLPs: mip-NeRF 360's cone-Gaussian IPE MLP and NeRF++'s point MLP.

Port of `ConeFieldMLP` and `PointFieldMLP` from the reference package's
`models/mlps.py`. Each layer is an `nn.Linear` whose weight is the
transpose of the Flax `Dense` kernel. `ConeFieldMLP`'s layer names map one
to one onto the Flax module's: `trunk{i}`, `density_head`, `normal_head`,
`roughness_head`, `bottleneck`, `view{i}` and `rgb_head`; its weights start
He-uniform. `PointFieldMLP`'s Flax layers are auto-named `Dense_{i}` in the
order they are made, which `flax_dense_names` lists; its weights start
Xavier-uniform. Biases start at zero.

`ConeFieldMLP` carries the Ref-NeRF options: density-gradient normals (the
gradient of the raw density with respect to the Gaussians' means, taken
inside the forward, so the loss differentiates through it), predicted
normals and roughness, the integrated directional encoding, reflection
directions and n.v, and it adds density and bottleneck noise when it is
given a generator, and a GLO vector to the view MLP's input.

A bfloat16 `compute_dtype` runs every layer in bfloat16 the way a Flax
`Dense(dtype=bfloat16)` does (`Dense` below): the parameters stay float32,
the inputs are cast where the reference casts them, and the density, normal,
roughness and rgb heads return to float32 before their activations.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils._python_dispatch import _disable_current_modes

from outdoor_nerf_depth_torch.ops import mathx, refdirs, spaces
from outdoor_nerf_depth_torch.parallel import mesh


class Dense(nn.Linear):
    """A Flax `Dense` with its compute dtype.

    In float32 it is `nn.Linear`. In bfloat16 the input, weight and bias are
    cast to bfloat16, the product (accumulated in float32 by the matmul) is
    rounded to bfloat16, and the bias is added in bfloat16, as the
    reference does; the parameters stay float32.
    """

    def __init__(self, fan_in: int, fan_out: int, compute_dtype=torch.float32):
        super().__init__(fan_in, fan_out)
        self.compute_dtype = mathx.as_dtype(compute_dtype)

    def forward(self, x):
        dtype = self.compute_dtype
        if dtype == torch.float32:
            return super().forward(x)
        return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


def _dense(fan_in: int, fan_out: int, generator: Optional[torch.Generator],
           init: str = "he", compute_dtype=torch.float32) -> Dense:
    layer = Dense(fan_in, fan_out, compute_dtype)
    if init == "he":
        # He-uniform (Flax `he_uniform`): U(-sqrt(6 / fan_in), sqrt(6 / fan_in)).
        nn.init.kaiming_uniform_(layer.weight, nonlinearity="relu", generator=generator)
    else:
        # Xavier-uniform: U(-sqrt(6 / (fan_in + fan_out)), ...).
        nn.init.xavier_uniform_(layer.weight, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class ConeFieldMLP(nn.Module):
    """IPE MLP over frustum Gaussians (prop/nerf field of mip-NeRF 360)."""

    def __init__(
        self,
        net_depth: int = 8,
        net_width: int = 256,
        bottleneck_width: int = 256,
        net_depth_viewdirs: int = 1,
        net_width_viewdirs: int = 128,
        skip_layer: int = 4,
        skip_layer_dir: int = 4,
        min_deg_point: int = 0,
        max_deg_point: int = 12,
        deg_view: int = 4,
        density_bias: float = -1.0,
        density_noise: float = 0.0,
        rgb_premultiplier: float = 1.0,
        rgb_bias: float = 0.0,
        rgb_padding: float = 0.001,
        bottleneck_noise: float = 0.0,
        warp: Optional[str] = None,
        basis_shape: str = "icosahedron",
        basis_subdivisions: int = 2,
        disable_rgb: bool = False,
        num_glo_features: int = 0,
        compute_density_normals: bool = False,
        enable_pred_normals: bool = False,
        use_directional_enc: bool = False,
        use_reflections: bool = False,
        enable_pred_roughness: bool = False,
        roughness_bias: float = -1.0,
        use_n_dot_v: bool = False,
        use_viewdirs: bool = True,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_reflections and not (compute_density_normals or enable_pred_normals):
            raise ValueError("reflection conditioning requires normals")
        if warp not in (None, "contract"):
            raise ValueError(f"unknown warp {warp!r}")

        self.net_depth = net_depth
        self.skip_layer = skip_layer
        self.skip_layer_dir = skip_layer_dir
        self.min_deg_point, self.max_deg_point = min_deg_point, max_deg_point
        self.deg_view = deg_view
        self.density_bias, self.density_noise = density_bias, density_noise
        self.rgb_premultiplier, self.rgb_bias = rgb_premultiplier, rgb_bias
        self.rgb_padding = rgb_padding
        self.bottleneck_noise = bottleneck_noise
        self.warp = warp
        self.disable_rgb = disable_rgb
        self.bottleneck_width = bottleneck_width
        self.compute_density_normals = compute_density_normals
        self.enable_pred_normals = enable_pred_normals
        self.use_directional_enc = use_directional_enc
        self.use_reflections = use_reflections
        self.enable_pred_roughness = enable_pred_roughness
        self.roughness_bias = roughness_bias
        self.use_n_dot_v = use_n_dot_v
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = dtype = mathx.as_dtype(compute_dtype)
        self.density_passes = None  # set by `reuse_density_passes`
        self.register_buffer(
            "basis", spaces.sphere_basis(basis_shape, basis_subdivisions), persistent=False
        )
        if use_directional_enc:
            self.dir_enc_fn = refdirs.generate_ide_fn(deg_view)
            dir_dim = 2 * refdirs._ide_tables(deg_view)[0].shape[1]
        else:
            self.dir_enc_fn = lambda d, _: spaces.pos_enc(d, 0, deg_view, append_identity=True)
            dir_dim = 3 + 6 * deg_view

        enc_dim = 2 * self.basis.shape[1] * (max_deg_point - min_deg_point)
        x_dim = enc_dim
        self.trunk_names = []
        for i in range(net_depth):
            name = f"trunk{i}"
            self.add_module(name, _dense(x_dim, net_width, generator, compute_dtype=dtype))
            self.trunk_names.append(name)
            x_dim = net_width + (enc_dim if i % skip_layer == 0 and i > 0 else 0)
        self.density_head = _dense(x_dim, 1, generator, compute_dtype=dtype)
        if enable_pred_normals:
            self.normal_head = _dense(x_dim, 3, generator, compute_dtype=dtype)
        if enable_pred_roughness:
            self.roughness_head = _dense(x_dim, 1, generator, compute_dtype=dtype)
        if disable_rgb:
            return
        y_dim = 0
        if bottleneck_width > 0:
            self.bottleneck = _dense(x_dim, bottleneck_width, generator, compute_dtype=dtype)
            y_dim += bottleneck_width
        if use_viewdirs:
            y_dim += dir_dim
            if use_n_dot_v and (compute_density_normals or enable_pred_normals):
                y_dim += 1
        y_dim += num_glo_features
        skip_dim = y_dim
        self.view_names = []
        for i in range(net_depth_viewdirs):
            name = f"view{i}"
            self.add_module(name, _dense(y_dim, net_width_viewdirs, generator,
                                         compute_dtype=dtype))
            self.view_names.append(name)
            y_dim = net_width_viewdirs + (skip_dim if i % skip_layer_dir == 0 and i > 0 else 0)
        self.rgb_head = _dense(y_dim, 3, generator, compute_dtype=dtype)

    def predict_density(self, means, covs):
        """Raw (pre-activation) density + trunk features for given Gaussians."""
        if self.warp == "contract":
            means, covs = spaces.track_gaussian(spaces.contract, means, covs)
        lifted_means, lifted_vars = spaces.project_and_diagonalize(means, covs, self.basis)
        x = spaces.integrated_pos_enc(
            lifted_means, lifted_vars, self.min_deg_point, self.max_deg_point
        ).to(self.compute_dtype)
        skip_in = x
        for i, name in enumerate(self.trunk_names):
            x = F.relu(getattr(self, name)(x))
            if i % self.skip_layer == 0 and i > 0:
                x = torch.cat([x, skip_in], dim=-1)
        return self.density_head(x)[..., 0].to(torch.float32), x

    def _density_and_normals(self, means, covs):
        """Raw density, trunk features and the density-gradient normals.

        raw_density_i depends on means_i alone, so one backward of the sum
        gives each point's gradient. With grad mode on (training), the
        gradient keeps its graph and the loss differentiates through it;
        under no_grad (evaluation) it is taken locally and detached.

        Inside a checkpointed forward (remat, `reuse_density_passes`) the
        pass keeps its own saved tensors (taking the gradient would
        otherwise unpack tensors the checkpoint dropped and recompute the
        region in the middle of the forward) and runs outside any dispatch
        mode, so `remat="dots"` neither caches nor counts its ops; the
        recompute in the backward replays its outputs instead of running it.
        """
        cache = self.density_passes
        if cache is not None and cache.replay:
            return cache.outputs.pop(0)
        create_graph = torch.is_grad_enabled()
        with contextlib.ExitStack() as stack:
            if cache is not None:
                stack.enter_context(torch.autograd.graph.saved_tensors_hooks(_keep, _keep))
                stack.enter_context(_disable_current_modes())
            stack.enter_context(torch.enable_grad())
            points = means if means.requires_grad else means.detach().requires_grad_(True)
            raw_density, x = self.predict_density(points, covs)
            (d_means,) = torch.autograd.grad(raw_density, points, torch.ones_like(raw_density),
                                             create_graph=create_graph)
            normals = -refdirs.l2_normalize(d_means)
        if not create_graph:
            raw_density, x = raw_density.detach(), x.detach()
        if cache is not None:
            cache.outputs.append((raw_density, x, normals))
        return raw_density, x, normals

    def forward(self, means, covs, viewdirs=None, glo_vec=None,
                generator: Optional[torch.Generator] = None):
        """means [..., S, 3], covs [..., S, 3, 3], viewdirs [..., 3], glo_vec
        [..., F] -> dict of density, rgb, normals, normals_pred and roughness
        (each None where its option is off). Noise is drawn from `generator`,
        density noise first; none without one."""
        if self.compute_density_normals:
            raw_density, x, normals = self._density_and_normals(means, covs)
        else:
            (raw_density, x), normals = self.predict_density(means, covs), None
        if generator is not None and self.density_noise > 0:
            raw_density = raw_density + self.density_noise * mesh.randn(
                raw_density.shape, generator=generator, dtype=raw_density.dtype,
                device=raw_density.device)
        out = {"density": F.softplus(raw_density + self.density_bias), "normals": normals,
               "normals_pred": None, "roughness": None}
        if self.enable_pred_normals:
            out["normals_pred"] = -refdirs.l2_normalize(self.normal_head(x).to(torch.float32))
        normals_to_use = out["normals_pred"] if self.enable_pred_normals else normals
        if self.enable_pred_roughness:
            out["roughness"] = F.softplus(
                self.roughness_head(x).to(torch.float32) + self.roughness_bias)
        if self.disable_rgb:
            out["rgb"] = torch.zeros_like(means)
            return out
        if (viewdirs is not None) != self.use_viewdirs:
            raise ValueError(f"built with use_viewdirs={self.use_viewdirs}")

        parts = []
        if self.bottleneck_width > 0:
            b = self.bottleneck(x)
            if generator is not None and self.bottleneck_noise > 0:
                noise = mesh.randn(b.shape, generator=generator, dtype=torch.float32,
                                    device=b.device)
                b = b + self.bottleneck_noise * noise.to(b.dtype)
            parts.append(b)
        sample_shape = means.shape[:-1]
        if viewdirs is not None:
            if self.use_reflections:
                refl = refdirs.reflect(-viewdirs[..., None, :], normals_to_use)
                roughness = out["roughness"]
                dir_enc = self.dir_enc_fn(
                    refl, roughness if roughness is not None else torch.zeros_like(refl[..., :1]))
            else:
                dir_enc = self.dir_enc_fn(
                    viewdirs,
                    torch.zeros_like(viewdirs[..., :1]) if self.use_directional_enc else None)
                dir_enc = dir_enc[..., None, :].expand(sample_shape + dir_enc.shape[-1:])
            parts.append(dir_enc.to(self.compute_dtype))
            if self.use_n_dot_v and normals_to_use is not None:
                n_dot_v = torch.sum(normals_to_use * viewdirs[..., None, :], dim=-1, keepdim=True)
                parts.append(n_dot_v.to(self.compute_dtype))
        if glo_vec is not None:
            parts.append(
                glo_vec[..., None, :].expand(sample_shape + glo_vec.shape[-1:]).to(self.compute_dtype))
        y = torch.cat(parts, dim=-1)
        skip_in = y
        for i, name in enumerate(self.view_names):
            y = F.relu(getattr(self, name)(y))
            if i % self.skip_layer_dir == 0 and i > 0:
                y = torch.cat([y, skip_in], dim=-1)
        rgb = torch.sigmoid(
            self.rgb_premultiplier * self.rgb_head(y).to(torch.float32) + self.rgb_bias
        )
        out["rgb"] = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
        return out


def _keep(t):
    """A saved-tensors hook that keeps the tensor as it is."""
    return t


class DensityPassCache:
    """The density passes' outputs of one forward, in order; `replay` makes
    the passes return them instead of running."""

    def __init__(self):
        self.outputs, self.replay = [], False


@contextlib.contextmanager
def reuse_density_passes(model: nn.Module, cache: DensityPassCache, replay: bool):
    """Within the block the density-normal passes of `model`'s cone MLPs
    record their outputs into `cache`, or, with `replay`, hand them back in
    order."""
    mlps = [m for m in model.modules() if isinstance(m, ConeFieldMLP)]
    cache.replay = replay
    for mlp in mlps:
        mlp.density_passes = cache
    try:
        yield cache
    finally:
        for mlp in mlps:
            mlp.density_passes = None


class PointFieldMLP(nn.Module):
    """Positional-encoding point MLP with |.| density (NeRF++'s fg/bg field).

    `input_dim` is 3 for the foreground and 4 for the inverted-sphere
    background (x', y', z', 1/r). The raw encoding joins the trunk after
    each layer in `skips` (but the last).
    """

    def __init__(
        self,
        input_dim: int = 3,
        net_depth: int = 8,
        net_width: int = 256,
        skips=(4,),
        pos_degrees: int = 10,
        view_degrees: int = 4,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = dtype = mathx.as_dtype(compute_dtype)
        self.pos_degrees, self.view_degrees = pos_degrees, view_degrees
        self.skips = tuple(i for i in skips if i != net_depth - 1)
        enc_dim = input_dim * (1 + 2 * pos_degrees)
        dir_dim = 3 * (1 + 2 * view_degrees)
        # (name, fan_in, fan_out) in the order the Flax module makes its Dense layers.
        layers, x_dim = [], enc_dim
        for i in range(net_depth):
            layers.append((f"trunk{i}", x_dim, net_width))
            x_dim = net_width + (enc_dim if i in self.skips else 0)
        layers += [("sigma_head", x_dim, 1), ("base", x_dim, net_width),
                   ("view", net_width + dir_dim, net_width // 2), ("rgb_head", net_width // 2, 3)]
        for name, fan_in, fan_out in layers:
            self.add_module(name, _dense(fan_in, fan_out, generator, init="xavier",
                                         compute_dtype=dtype))
        self.flax_dense_names = [name for name, _, _ in layers]
        self.trunk_names = self.flax_dense_names[:net_depth]

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor):
        """pts [..., S, input_dim], viewdirs [..., 3] (per ray) or [..., S, 3]
        -> (sigma [..., S], rgb [..., S, 3])."""
        x = spaces.pos_enc(pts, 0, self.pos_degrees).to(self.compute_dtype)
        skip_in = x
        for i, name in enumerate(self.trunk_names):
            x = F.relu(getattr(self, name)(x))
            if i in self.skips:
                x = torch.cat([x, skip_in], dim=-1)
        sigma = mathx.abs_(self.sigma_head(x).to(torch.float32)[..., 0])
        base = self.base(x)
        dir_enc = spaces.pos_enc(viewdirs, 0, self.view_degrees).to(self.compute_dtype)
        if dir_enc.dim() == base.dim() - 1:  # per-ray directions: broadcast over S
            dir_enc = dir_enc[..., None, :].expand(base.shape[:-1] + dir_enc.shape[-1:])
        y = F.relu(self.view(torch.cat([base, dir_enc], dim=-1)))
        return sigma, torch.sigmoid(self.rgb_head(y).to(torch.float32))
