"""The cone-Gaussian IPE field MLP of mip-NeRF 360.

Port of `ConeFieldMLP` from the reference package's `models/mlps.py`, with
the options the flagship configuration uses. Layer names map one to one onto
the Flax module's: `trunk{i}`, `density_head`, `bottleneck`, `view{i}` and
`rgb_head`, each an `nn.Linear` whose weight is the transpose of the Flax
`Dense` kernel. Weights start He-uniform, biases zero.

Not ported in this slice (they raise NotImplementedError): the Ref-NeRF
options (density or predicted normals, integrated directional encoding,
reflections, roughness, n.v), density and bottleneck noise, GLO vectors,
and a bfloat16 compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from outdoor_nerf_depth_torch.ops import spaces

_REF_NERF_OPTIONS = (
    "compute_density_normals",
    "enable_pred_normals",
    "use_directional_enc",
    "use_reflections",
    "enable_pred_roughness",
    "use_n_dot_v",
)


def _dense(fan_in: int, fan_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out)
    # He-uniform (Flax `he_uniform`): U(-sqrt(6 / fan_in), sqrt(6 / fan_in)).
    nn.init.kaiming_uniform_(layer.weight, nonlinearity="relu", generator=generator)
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
        if compute_dtype not in ("float32", torch.float32):
            unported.append(f"compute_dtype={compute_dtype}")
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
        self.register_buffer(
            "basis", spaces.sphere_basis(basis_shape, basis_subdivisions), persistent=False
        )

        enc_dim = 2 * self.basis.shape[1] * (max_deg_point - min_deg_point)
        x_dim = enc_dim
        self.trunk_names = []
        for i in range(net_depth):
            name = f"trunk{i}"
            self.add_module(name, _dense(x_dim, net_width, generator))
            self.trunk_names.append(name)
            x_dim = net_width + (enc_dim if i % skip_layer == 0 and i > 0 else 0)
        self.density_head = _dense(x_dim, 1, generator)
        if disable_rgb:
            return
        y_dim = 0
        if bottleneck_width > 0:
            self.bottleneck = _dense(x_dim, bottleneck_width, generator)
            y_dim += bottleneck_width
        if use_viewdirs:
            y_dim += 3 + 6 * deg_view  # pos_enc(viewdirs, 0, deg_view) with identity
        skip_dim = y_dim
        self.view_names = []
        for i in range(net_depth_viewdirs):
            name = f"view{i}"
            self.add_module(name, _dense(y_dim, net_width_viewdirs, generator))
            self.view_names.append(name)
            y_dim = net_width_viewdirs + (skip_dim if i % skip_layer_dir == 0 and i > 0 else 0)
        self.rgb_head = _dense(y_dim, 3, generator)

    def predict_density(self, means, covs):
        """Raw (pre-activation) density + trunk features for given Gaussians."""
        if self.warp == "contract":
            means, covs = spaces.track_gaussian(spaces.contract, means, covs)
        lifted_means, lifted_vars = spaces.project_and_diagonalize(means, covs, self.basis)
        x = spaces.integrated_pos_enc(
            lifted_means, lifted_vars, self.min_deg_point, self.max_deg_point
        )
        skip_in = x
        for i, name in enumerate(self.trunk_names):
            x = F.relu(getattr(self, name)(x))
            if i % self.skip_layer == 0 and i > 0:
                x = torch.cat([x, skip_in], dim=-1)
        return self.density_head(x)[..., 0], x

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
            parts.append(dir_enc[..., None, :].expand(means.shape[:-1] + dir_enc.shape[-1:]))
        y = torch.cat(parts, dim=-1)
        skip_in = y
        for i, name in enumerate(self.view_names):
            y = F.relu(getattr(self, name)(y))
            if i % self.skip_layer_dir == 0 and i > 0:
                y = torch.cat([y, skip_in], dim=-1)
        rgb = torch.sigmoid(self.rgb_premultiplier * self.rgb_head(y) + self.rgb_bias)
        out["rgb"] = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
        return out
