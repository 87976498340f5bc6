"""Plain PyTorch Instant-NGP: the benchmark's frozen reference of the port's
NGP configuration (train step, occupancy refresh and the dense renderer).

A frozen copy of the math of the port's `models/ngp.py`,
`ops/occupancy.py` and the osplit layout of `ops/hashgrid.py`, written in
the canonical form: each cell corner's row of the [L, T, F] table is
gathered directly under the linear hash, (x P1 + y P2 + z) mod T, or x s^2
+ y s + z on levels whose grid fits the table. The layout's rounding is
part of the configuration and kept: the table is read in bfloat16, and each
corner's gradient product is rounded to bfloat16 before the float32 sum
(here an index_add instead of the port's sort and K2a scan). The
compositing weights use an exclusive cumsum instead of the port's K1. It
imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PRIMES = (1, 2_654_435_761, 805_459_861)
SQRT3 = math.sqrt(3.0)
INVALID_KEY = 1 << 20  # larger than any slot index


# ------------------------------------------------------------------ shapes


def num_cascades(scale: float) -> int:
    return max(1 + int(np.ceil(np.log2(max(2 * scale, 1e-8)))), 1)


def cascade_extents(scale: float) -> np.ndarray:
    return np.minimum(scale, 2.0 ** (np.arange(num_cascades(scale)) - 1))


def level_resolutions(n_levels: int, n_min: int, n_max: int):
    b = float(np.exp((np.log(n_max) - np.log(n_min)) / (n_levels - 1))) if n_levels > 1 else 1.0
    return [int(r) for r in np.floor(n_min * b ** np.arange(n_levels)).astype(np.int32)]


class Shapes:
    """Every size of the configuration the reference needs."""

    def __init__(self, mp: dict):
        fp = mp.get("field_params") or {}
        self.scale = mp.get("scale", 0.5)
        self.grid_res = mp.get("grid_resolution", 128)
        self.max_samples = mp.get("max_samples", 128)
        self.n_candidates = mp.get("n_candidates", 512)
        self.sample_budget = mp.get("sample_budget", 0)
        self.exponential = mp.get("exponential_steps")
        if self.exponential is None:
            self.exponential = self.scale > 0.5
        self.near_distance = mp.get("near_distance", 0.01)
        self.density_threshold = mp.get("density_threshold", 0.01)
        self.n_levels = fp.get("n_levels", 16)
        self.n_feats = fp.get("n_features", 2)
        self.table_size = 2 ** fp.get("log2_table_size", 19)
        self.base_res = fp.get("base_resolution", 16)
        self.max_res = fp.get("max_resolution", 0) or max(int(2048 * 2 * self.scale),
                                                          self.base_res + 1)
        self.geo = fp.get("geo_features", 15)
        self.hidden = fp.get("hidden_width", 64)
        self.rgb_layers = fp.get("rgb_hidden_layers", 2)
        self.resolutions = level_resolutions(self.n_levels, self.base_res, self.max_res)
        self.e_max = float(cascade_extents(self.scale)[-1])


def init_params(mp: dict, seed: int) -> dict:
    """Flat {name: float32 tensor} on the CPU, drawn as the port draws them:
    the table U(-1e-4, 1e-4), then He-uniform dense weights, zero biases."""
    s = Shapes(mp)
    gen = torch.Generator().manual_seed(seed)
    out = {"field.encoder.table": torch.empty(s.n_levels, s.table_size, s.n_feats).uniform_(
        -1e-4, 1e-4, generator=gen)}
    layers = [("sigma_hidden", s.n_levels * s.n_feats, s.hidden), ("sigma_out", s.hidden, 1 + s.geo)]
    y = 16 + s.geo
    for i in range(s.rgb_layers):
        layers.append((f"rgb_hidden{i}", y, s.hidden))
        y = s.hidden
    layers.append(("rgb_out", y, 3))
    for name, fan_in, fan_out in layers:
        bound = math.sqrt(3.0) * (math.sqrt(2.0) / math.sqrt(fan_in))
        out[f"field.{name}.weight"] = torch.empty(fan_out, fan_in).uniform_(-bound, bound,
                                                                            generator=gen)
        out[f"field.{name}.bias"] = torch.zeros(fan_out)
    return out


# --------------------------------------------------------------- hash grid


def _dense_level(res: int, table_size: int) -> bool:
    return (res + 1) ** 3 <= table_size


def corner_rows(x, s: Shapes):
    """Canonical rows [..., L, 8] of every corner and trilinear weights [..., L, 8]."""
    x = torch.clamp(x, 0.0, 1.0)
    bits = torch.tensor([[(c >> (2 - d)) & 1 for d in range(3)] for c in range(8)],
                        dtype=torch.int64, device=x.device)
    rows, weights = [], []
    for res in s.resolutions:
        pos = x * res
        cell = torch.clamp(torch.floor(pos).to(torch.int64), 0, res - 1)
        frac = pos - cell
        corner = cell[..., None, :] + bits  # [..., 8, 3]
        if _dense_level(res, s.table_size):
            n = res + 1
            row = corner[..., 0] * (n * n) + corner[..., 1] * n + corner[..., 2]
        else:
            row = (corner[..., 0] * PRIMES[1] + corner[..., 1] * PRIMES[2]
                   + corner[..., 2]) & (s.table_size - 1)
        fd = torch.where(bits.bool(), frac[..., None, :], 1.0 - frac[..., None, :])
        rows.append(row)
        weights.append(fd[..., 0] * fd[..., 1] * fd[..., 2])
    return torch.stack(rows, dim=-2), torch.stack(weights, dim=-2)


class _Encode(torch.autograd.Function):
    """Features [..., L F] of the bf16-rounded table; its gradient is the sum
    of each corner's bf16-rounded product, in float32."""

    @staticmethod
    def forward(ctx, table, rows, weights):
        n_levels, _, n_feats = table.shape
        level = torch.arange(n_levels, device=table.device)[:, None]
        feats = table.to(torch.bfloat16)[level, rows].to(torch.float32)  # [..., L, 8, F]
        ctx.save_for_backward(rows, weights)
        ctx.table_shape = table.shape
        out = torch.sum(weights[..., None] * feats, dim=-2)
        return out.reshape(out.shape[:-2] + (n_levels * n_feats,))

    @staticmethod
    def backward(ctx, g):
        rows, weights = ctx.saved_tensors
        n_levels, table_size, n_feats = ctx.table_shape
        g = g.to(torch.float32).reshape(g.shape[:-1] + (n_levels, n_feats))
        vals = (weights[..., None] * g[..., None, :]).to(torch.bfloat16).to(torch.float32)
        flat = rows + torch.arange(n_levels, device=rows.device)[:, None] * table_size
        grad = torch.zeros(n_levels * table_size, n_feats, device=g.device)
        grad.index_add_(0, flat.reshape(-1), vals.reshape(-1, n_feats))
        return grad.reshape(ctx.table_shape), None, None


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -15.0, 15.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def spherical_harmonics(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        0.28209479177387814 * torch.ones_like(x), -0.48860251190291987 * y,
        0.48860251190291987 * z, -0.48860251190291987 * x, 1.0925484305920792 * xy,
        -1.0925484305920792 * yz, 0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], dim=-1)


def dense(params, name, x):
    return F.linear(x, params[f"field.{name}.weight"], params[f"field.{name}.bias"])


def density(params, s: Shapes, pts):
    """sigma [...] and geometry features [..., geo] of world points."""
    rows, weights = corner_rows(pts / (2.0 * s.e_max) + 0.5, s)
    enc = _Encode.apply(params["field.encoder.table"], rows, weights)
    h = dense(params, "sigma_out", F.relu(dense(params, "sigma_hidden", enc)))
    return _TruncExp.apply(h[..., 0]), h[..., 1:]


def field(params, s: Shapes, pts, viewdirs):
    sigma, feats = density(params, s, pts)
    sh = spherical_harmonics(viewdirs)
    y = torch.cat([sh.expand(feats.shape[:-1] + sh.shape[-1:]), feats], dim=-1)
    for i in range(s.rgb_layers):
        y = F.relu(dense(params, f"rgb_hidden{i}", y))
    return sigma, torch.sigmoid(dense(params, "rgb_out", y))


# --------------------------------------------------------------- occupancy


def point_cascade(x, s: Shapes):
    maxc = torch.amax(torch.abs(x), dim=-1)
    casc = torch.ceil(torch.log2(torch.clamp(maxc, min=1e-8)) + 1.0).to(torch.int64)
    return torch.clamp(casc, 0, num_cascades(s.scale) - 1)


def occupied_at(grid, x, s: Shapes, threshold):
    casc = point_cascade(x, s)
    extent = torch.clamp(torch.pow(2.0, casc.to(torch.float32) - 1.0), max=s.scale)
    u = (x / (2.0 * extent[..., None]) + 0.5) * s.grid_res
    cell = torch.clamp(u.to(torch.int64), 0, s.grid_res - 1)
    flat = cell[..., 0] * s.grid_res**2 + cell[..., 1] * s.grid_res + cell[..., 2]
    return grid[casc, flat] > threshold


def mean_density(grid):
    return torch.mean(torch.clamp(grid[0], min=0.0))


@torch.no_grad()
def refresh(params, s: Shapes, grid, generator, decay: float, n_per_cascade: int,
            chunk: int = 131_072):
    """One grid refresh: decay every cell, then the max with fresh densities
    at jittered points of every cell (warm-up, n_per_cascade 0) or of
    sampled cells (half uniform, half Gumbel-top-k over the occupied)."""
    c, n_cells = grid.shape
    dev = grid.device
    if n_per_cascade <= 0:
        cells = torch.arange(n_cells, device=dev).expand(c, n_cells)
    else:
        m = min(n_per_cascade, n_cells)
        k_uniform = m // 2
        k_occ = m - k_uniform
        uniform = torch.randint(0, n_cells, (c, k_uniform), generator=generator, device=dev)
        occ = grid > s.density_threshold
        u = torch.rand((c, n_cells), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        top = torch.topk(torch.where(occ, gumbel, float("-inf")), k_occ, dim=-1).indices
        fallback = torch.randint(0, n_cells, (c, k_occ), generator=generator, device=dev)
        cells = torch.cat([uniform, torch.where(occ.any(dim=-1, keepdim=True), top, fallback)],
                          dim=-1)
    jitter = torch.rand(cells.shape + (3,), generator=generator, device=dev)
    r = s.grid_res
    coords = torch.stack([cells // (r * r), (cells // r) % r, cells % r], dim=-1).to(torch.float32)
    extents = torch.as_tensor(cascade_extents(s.scale), dtype=torch.float32, device=dev)
    pts = (((coords + jitter) / r - 0.5) * 2.0 * extents[:, None, None]).reshape(-1, 3)
    sigma = torch.cat([density(params, s, pts[i:i + chunk])[0]
                       for i in range(0, pts.shape[0], chunk)])
    flat = (torch.arange(c, device=dev)[:, None] * n_cells + cells).reshape(-1)
    updated = (grid * decay).reshape(-1).scatter_reduce(
        0, flat, torch.clamp(sigma.reshape(-1), min=0.0), "amax", include_self=True)
    return torch.where(grid < 0, grid, updated.reshape(c, n_cells))


# ------------------------------------------------------------------ render


def render(params, s: Shapes, rays: dict, grid, generator):
    """The dense renderer of the train path: (rendering, history)."""
    o, vd = rays["origins"], rays["viewdirs"]
    inv_d = 1.0 / torch.where(torch.abs(vd) < 1e-10, 1e-10, vd)
    t0, t1 = (-s.e_max - o) * inv_d, (s.e_max - o) * inv_d
    t_near = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=s.near_distance)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = t_far > t_near
    t_near = torch.maximum(t_near, rays["near"][..., 0])
    t_far = torch.maximum(torch.minimum(t_far, rays["far"][..., 0]), t_near + 1e-4)
    n = s.n_candidates
    frac = torch.arange(n + 1, dtype=torch.float32, device=o.device) / n
    if s.exponential:
        ratio = torch.clamp(t_far / torch.clamp(t_near, min=1e-6), min=1.0 + 1e-6)
        edges = t_near[..., None] * ratio[..., None] ** frac
    else:
        edges = t_near[..., None] + (t_far - t_near)[..., None] * frac
    if generator is not None:
        widths = torch.diff(edges, dim=-1)
        u = torch.rand(widths[..., :-1].shape, generator=generator, device=o.device) - 0.5
        interior = edges[..., 1:-1] + u * torch.minimum(widths[..., :-1], widths[..., 1:])
        edges = torch.cat([edges[..., :1], interior, edges[..., -1:]], dim=-1)
    mids = 0.5 * (edges[..., :-1] + edges[..., 1:])
    pts_all = o[..., None, :] + mids[..., None] * vd[..., None, :]
    thresh = torch.clamp(mean_density(grid), max=s.density_threshold)
    occupied = occupied_at(grid, pts_all, s, thresh) & hit[..., None]
    rm = torch.sum(occupied, dim=-1)
    # At most max_samples occupied intervals a ray: every k-th when more.
    k = s.max_samples
    n_occ = torch.sum(occupied, dim=-1, keepdim=True)
    step = torch.clamp((n_occ + k - 1) // k, min=1)
    rank = torch.cumsum(occupied, dim=-1) - 1
    occupied = occupied & (rank % step == 0)
    take = torch.sort(torch.where(occupied, 0, 1), dim=-1, stable=True).indices[..., :k]
    lo, hi = torch.gather(edges[..., :-1], -1, take), torch.gather(edges[..., 1:], -1, take)
    valid = torch.gather(occupied, -1, take)
    t_mid = torch.where(valid, 0.5 * (lo + hi), 0.0)
    dt = torch.where(valid, (hi - lo) * step.to(torch.float32), 0.0)
    pts = torch.where(valid[..., None], o[..., None, :] + t_mid[..., None] * vd[..., None, :], 0.0)
    if s.sample_budget and s.sample_budget < k:
        # The field runs on the first (batch x budget) valid slots, ordered
        # by slot index, then ray: every ray loses its farthest samples alike.
        m = valid.numel()
        slot = torch.arange(k, device=o.device).expand(valid.shape).reshape(m)
        key = torch.where(valid.reshape(m), 0, INVALID_KEY) + slot
        sel = torch.sort(key, stable=True).indices[:valid[..., 0].numel() * s.sample_budget]
        sigma_c, rgb_c = field(params, s, pts.reshape(-1, 3)[sel], vd.reshape(-1, 3)[sel // k])
        sigma = torch.zeros(m, device=o.device).index_put((sel,), sigma_c).reshape(valid.shape)
        rgb = torch.zeros(m, 3, device=o.device).index_put((sel,), rgb_c).reshape(
            valid.shape + (3,))
    else:
        sigma, rgb = field(params, s, pts, vd[..., None, :])
    sigma = torch.where(valid, sigma, 0.0)
    tau = torch.clamp(sigma * dt, max=1e4)
    p = torch.cat([torch.zeros_like(tau[..., :1]), torch.cumsum(tau[..., :-1], dim=-1)], dim=-1)
    weights = torch.exp(-p) - torch.exp(-(p + tau))
    acc = torch.sum(weights, dim=-1)
    rendering = {"rgb": torch.sum(weights[..., None] * rgb, dim=-2), "depth": torch.sum(weights * t_mid, dim=-1),
                 "acc": acc, "rm": rm, "vr": torch.sum(valid, dim=-1)}
    return rendering, {"weights": weights, "steps": t_mid, "lengths": dt}


def loss(cfg: dict, batch: dict, rendering, history):
    """mse rgb, mse depth over the valid depths, point-sampled distortion and opacity entropy."""
    target = batch["rgb"][..., :3]
    lossmult = batch["lossmult"].expand(target.shape)
    total = (lossmult * (rendering["rgb"] - target) ** 2).sum() / torch.clamp(lossmult.sum(),
                                                                               min=1e-8)
    sup = batch["depth_sup"]
    mask = (sup > 0).to(rendering["depth"].dtype)
    per_ray = (mask * rendering["depth"] - mask * sup) ** 2
    total = total + cfg["lambda_depth"] * per_ray.sum() / torch.clamp(mask.sum(), min=1.0)
    if cfg.get("distortion_loss_mult", 0.01) > 0:
        w, t, dt = history["weights"], history["steps"], history["lengths"]
        pair = torch.abs(t[..., :, None] - t[..., None, :])
        inter = torch.sum(w * torch.sum(w[..., None, :] * pair, dim=-1), dim=-1)
        total = total + cfg["distortion_loss_mult"] * torch.mean(
            inter + torch.sum(w**2 * dt, dim=-1) / 3.0)
    if cfg.get("opacity_loss_mult", 0.0) > 0:
        a = torch.clamp(rendering["acc"], 1e-5, 1.0 - 1e-5)
        total = total + cfg["opacity_loss_mult"] * torch.mean(-a * torch.log(a))
    return total
