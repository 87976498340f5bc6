"""The field MLPs: mip-NeRF 360's cone-Gaussian IPE MLP and NeRF++'s point MLP.

Port of `ConeFieldMLP` (with the options the flagship configuration uses)
and `PointFieldMLP` from the reference package's `models/mlps.py`. Each
layer is an `nn.Linear` whose weight is the transpose of the Flax `Dense`
kernel. `ConeFieldMLP`'s layer names map one to one onto the Flax
module's: `trunk{i}`, `density_head`, `bottleneck`, `view{i}` and
`rgb_head`; its weights start He-uniform. `PointFieldMLP`'s Flax layers
are auto-named `Dense_{i}` in the order they are made, which
`flax_dense_names` lists; its weights start Xavier-uniform. Biases start
at zero.

A bfloat16 `compute_dtype` runs every layer in bfloat16 the way a Flax
`Dense(dtype=bfloat16)` does (`Dense` below): the parameters stay float32,
the inputs are cast where the reference casts them, and the density and
rgb heads return to float32 before their activations.

Not ported in this slice (they raise NotImplementedError): the Ref-NeRF
options (density or predicted normals, integrated directional encoding,
reflections, roughness, n.v), density and bottleneck noise and GLO vectors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from outdoor_nerf_depth_torch.ops import mathx, spaces

_REF_NERF_OPTIONS = (
    "compute_density_normals",
    "enable_pred_normals",
    "use_directional_enc",
    "use_reflections",
    "enable_pred_roughness",
    "use_n_dot_v",
)


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
        use_viewdirs: bool = True,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        **ref_nerf_options,
    ):
        super().__init__()
        unknown = set(ref_nerf_options) - set(_REF_NERF_OPTIONS) - {"roughness_bias"}
        if unknown:
            raise TypeError(f"unknown ConeFieldMLP options {sorted(unknown)}")
        unported = [k for k in _REF_NERF_OPTIONS if ref_nerf_options.get(k)]
        if density_noise > 0 or bottleneck_noise > 0:
            unported.append("density_noise/bottleneck_noise")
        if num_glo_features > 0:
            unported.append("num_glo_features")
        if unported:
            raise NotImplementedError(f"ConeFieldMLP options not ported yet: {unported}")
        if warp not in (None, "contract"):
            raise ValueError(f"unknown warp {warp!r}")

        self.net_depth = net_depth
        self.skip_layer = skip_layer
        self.skip_layer_dir = skip_layer_dir
        self.min_deg_point, self.max_deg_point = min_deg_point, max_deg_point
        self.deg_view = deg_view
        self.density_bias = density_bias
        self.rgb_premultiplier, self.rgb_bias = rgb_premultiplier, rgb_bias
        self.rgb_padding = rgb_padding
        self.warp = warp
        self.disable_rgb = disable_rgb
        self.bottleneck_width = bottleneck_width
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = dtype = mathx.as_dtype(compute_dtype)
        self.register_buffer(
            "basis", spaces.sphere_basis(basis_shape, basis_subdivisions), persistent=False
        )

        enc_dim = 2 * self.basis.shape[1] * (max_deg_point - min_deg_point)
        x_dim = enc_dim
        self.trunk_names = []
        for i in range(net_depth):
            name = f"trunk{i}"
            self.add_module(name, _dense(x_dim, net_width, generator, compute_dtype=dtype))
            self.trunk_names.append(name)
            x_dim = net_width + (enc_dim if i % skip_layer == 0 and i > 0 else 0)
        self.density_head = _dense(x_dim, 1, generator, compute_dtype=dtype)
        if disable_rgb:
            return
        y_dim = 0
        if bottleneck_width > 0:
            self.bottleneck = _dense(x_dim, bottleneck_width, generator, compute_dtype=dtype)
            y_dim += bottleneck_width
        if use_viewdirs:
            y_dim += 3 + 6 * deg_view  # pos_enc(viewdirs, 0, deg_view) with identity
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

    def forward(self, means, covs, viewdirs=None):
        """means [..., S, 3], covs [..., S, 3, 3], viewdirs [..., 3] -> dict."""
        raw_density, x = self.predict_density(means, covs)
        out = {"density": F.softplus(raw_density + self.density_bias)}
        if self.disable_rgb:
            out["rgb"] = torch.zeros_like(means)
            return out
        if (viewdirs is not None) != self.use_viewdirs:
            raise ValueError(f"built with use_viewdirs={self.use_viewdirs}")

        parts = []
        if self.bottleneck_width > 0:
            parts.append(self.bottleneck(x))
        if viewdirs is not None:
            dir_enc = spaces.pos_enc(viewdirs, 0, self.deg_view, append_identity=True)
            dir_enc = dir_enc.to(self.compute_dtype)
            parts.append(dir_enc[..., None, :].expand(means.shape[:-1] + dir_enc.shape[-1:]))
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
