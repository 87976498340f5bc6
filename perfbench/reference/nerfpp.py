"""Plain PyTorch NeRF++ train step: the benchmark's frozen reference.

A frozen copy of the math the port's NeRF++ configuration runs
(`models/nerfpp.py`, `models/mlps.py:PointFieldMLP`, `ops/geometry.py`,
`ops/stepfuns.py:sample`, `ops/spaces.py:pos_enc`, the mse rgb and depth
terms of `train/losses.py` and the loss assembly of `train/step.py`; the
per-level clipping and Adam are in `reference/nerfpp_check.py:follow`), cut
to the options that configuration uses: no autoexposure, bf16 or remat. It
imports nothing of the program. Parameters
are a flat dict named as the port's modules name theirs, initialized from
the seed in the port's order (Xavier-uniform weights, zero biases; level 0's
foreground field, then its background field, then level 1's).

The inverted-sphere model: a foreground field on the points inside the unit
sphere and a background field on the inverted sphere's 4-D points (x', y',
z', 1/r), each an 8x256 point MLP with the encoding joined again after layer
4, |.| density and a sigmoid colour; each composited by
cumprod(1 - alpha + 1e-6), the background's outermost shell 1e10 wide, and
merged through the foreground's exit transmittance. Level 0 draws stratified
foreground distances and inverse radii; each later level draws as many more
of each by inverse CDF from the last level's weights and merges them in by
a sort.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import mip as mip_ref

HUGE = 1e10
TINY = 1e-6
EPS = torch.finfo(torch.float32).eps


# ------------------------------------------------------------------ params


def mlp_layers(model_params: dict, input_dim: int):
    """[(name, fan_in, fan_out)] of one point field MLP, in construction order."""
    depth, width = model_params.get("net_depth", 8), model_params.get("net_width", 256)
    enc = input_dim * (1 + 2 * model_params.get("pos_degrees", 10))
    dirs = 3 * (1 + 2 * model_params.get("view_degrees", 4))
    skips = skip_layers(depth)
    out, x = [], enc
    for i in range(depth):
        out.append((f"trunk{i}", x, width))
        x = width + (enc if i in skips else 0)
    return out + [("sigma_head", x, 1), ("base", x, width), ("view", width + dirs, width // 2),
                  ("rgb_head", width // 2, 3)]


def skip_layers(depth: int):
    """The trunk layers after which the encoding joins again: 4, unless it is the last."""
    return tuple(i for i in (4,) if i != depth - 1)


def fields(model_params: dict):
    """[(prefix, input_dim)] of every field MLP, in construction order."""
    levels = len(model_params.get("cascade_samples", (64, 128)))
    return [(f"level{level}.{kind}_field", dim) for level in range(levels)
            for kind, dim in (("fg", 3), ("bg", 4))]


def init_params(model_params: dict, seed: int) -> dict:
    """Flat {name: float32 tensor} on the CPU, drawn as the port draws them."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for prefix, input_dim in fields(model_params):
        for name, fan_in, fan_out in mlp_layers(model_params, input_dim):
            bound = math.sqrt(3.0) * math.sqrt(2.0 / float(fan_in + fan_out))
            w = torch.empty(fan_out, fan_in).uniform_(-bound, bound, generator=gen)
            out[f"{prefix}.{name}.weight"] = w
            out[f"{prefix}.{name}.bias"] = torch.zeros(fan_out)
    return out


def groups(params: dict):
    """The levels (the model's top-level modules), each clipped on its own."""
    out = {}
    for k in params:
        out.setdefault(k.split(".")[0], []).append(k)
    return out


# ---------------------------------------------------------------- geometry


def _norm(x, keepdim: bool = False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0 + TINY, 1.0 - TINY))


def intersect_unit_sphere(o, d):
    """Distance along each ray to its exit from the unit sphere (origins inside it)."""
    d_dot = torch.sum(d * d, dim=-1)
    t_mid = -torch.sum(d * o, dim=-1) / d_dot
    p_mid = o + t_mid[..., None] * d
    p_sq = torch.sum(p_mid * p_mid, dim=-1)
    return t_mid + torch.sqrt(torch.clamp(1.0 - p_sq, min=0.0)) / torch.sqrt(d_dot)


def inverted_sphere_points(o, d, inv_r):
    """The background point at radius 1/inv_r: the sphere exit rotated in the
    ray's plane (Rodrigues) onto that sphere. (pts [..., 4], distance along the ray)."""
    d_dot = torch.sum(d * d, dim=-1)
    t_mid = -torch.sum(d * o, dim=-1) / d_dot
    p_mid = o + t_mid[..., None] * d
    p_mid_r = _norm(p_mid)
    inv_d_norm = 1.0 / torch.sqrt(d_dot)
    half_chord = torch.sqrt(torch.clamp(1.0 - p_mid_r**2, min=0.0)) * inv_d_norm
    p_exit = o + (t_mid + half_chord)[..., None] * d
    axis = torch.linalg.cross(o, p_exit, dim=-1)
    axis = axis / torch.clamp(_norm(axis, keepdim=True), min=TINY)
    angle = (_safe_asin(p_mid_r) - _safe_asin(p_mid_r * inv_r))[..., None]
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    rotated = (p_exit * cos_a + torch.linalg.cross(axis, p_exit, dim=-1) * sin_a
               + axis * torch.sum(axis * p_exit, dim=-1, keepdim=True) * (1.0 - cos_a))
    rotated = rotated / torch.clamp(_norm(rotated, keepdim=True), min=TINY)
    theta = _safe_asin(p_mid_r * inv_r)
    t_metric = torch.cos(theta) * inv_d_norm / torch.clamp(inv_r, min=TINY) + t_mid
    return torch.cat([rotated, inv_r[..., None]], dim=-1), t_metric


# ---------------------------------------------------------------- sampling


def jitter(generator, z):
    """Stratified jitter of point samples within their mid-to-mid cells."""
    mid = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mid, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mid], dim=-1)
    u = torch.rand(z.shape, generator=generator, dtype=z.dtype, device=z.device)
    return lower + (upper - lower) * u


def resample(generator, weights, z, n: int):
    """n new points by inverse CDF from the histogram of `weights` over the
    midpoints of `z` (the two end samples' weights dropped), each jittered
    in its own stratum."""
    t = 0.5 * (z[..., 1:] + z[..., :-1])
    logits = torch.log(weights[..., 1:-1] + 1e-8)
    u_ceil = EPS + (1.0 - EPS) / n
    span = (1.0 - u_ceil) / (n - 1) - EPS
    base = torch.linspace(0.0, 1.0 - u_ceil, n, dtype=t.dtype, device=t.device)
    u = base + torch.rand(t.shape[:-1] + (n,), generator=generator, dtype=t.dtype,
                          device=t.device) * span
    cdf = mip_ref.integrate_weights(torch.softmax(logits, dim=-1))
    return mip_ref.sorted_interp(u, cdf, t)


# ------------------------------------------------------------------- model


def field(params, prefix, mp: dict, pts, viewdirs):
    """(sigma [..., S], rgb [..., S, 3]) of one point field MLP."""
    x = mip_ref.pos_enc(pts, mp.get("pos_degrees", 10))
    skip_in, skips = x, skip_layers(mp.get("net_depth", 8))
    for i in range(mp.get("net_depth", 8)):
        x = F.relu(mip_ref.dense(params, f"{prefix}.trunk{i}", x))
        if i in skips:
            x = torch.cat([x, skip_in], dim=-1)
    raw = mip_ref.dense(params, f"{prefix}.sigma_head", x)[..., 0]
    sigma = torch.where(raw >= 0, raw, -raw)  # |.| with gradient +1 at 0
    base = mip_ref.dense(params, f"{prefix}.base", x)
    enc = mip_ref.pos_enc(viewdirs, mp.get("view_degrees", 4))
    enc = enc[..., None, :].expand(base.shape[:-1] + enc.shape[-1:])
    y = F.relu(mip_ref.dense(params, f"{prefix}.view", torch.cat([base, enc], dim=-1)))
    return sigma, torch.sigmoid(mip_ref.dense(params, f"{prefix}.rgb_head", y))


def composite(sigma, rgb, lengths):
    """Weights cumprod(1 - alpha + 1e-6) and the composited colour."""
    alpha = 1.0 - torch.exp(-sigma * lengths)
    surv = torch.cumprod(1.0 - alpha + TINY, dim=-1)
    trans = torch.cat([torch.ones_like(surv[..., :1]), surv[..., :-1]], dim=-1)
    weights = alpha * trans
    return weights, surv[..., -1], torch.sum(weights[..., None] * rgb, dim=-2)


def render_level(params, mp, level: int, o, d, fg_far, fg_z, bg_inv_r):
    d_norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    viewdirs = d / d_norm
    fg_pts = o[..., None, :] + fg_z[..., None] * d[..., None, :]
    sigma, rgb = field(params, f"level{level}.fg_field", mp, fg_pts, viewdirs)
    fg_len = d_norm * torch.cat([torch.diff(fg_z, dim=-1), fg_far[..., None] - fg_z[..., -1:]],
                                dim=-1)
    fg_w, bg_lambda, fg_rgb = composite(sigma, rgb, fg_len)
    fg_depth = torch.sum(fg_w * fg_z, dim=-1)

    inv_r = torch.flip(bg_inv_r, dims=(-1,))  # near to far: descending inverse radius
    shape = bg_inv_r.shape + (3,)
    pts, t = inverted_sphere_points(o[..., None, :].expand(shape), d[..., None, :].expand(shape),
                                    inv_r)
    sigma, rgb = field(params, f"level{level}.bg_field", mp, pts, viewdirs)
    bg_len = torch.cat([inv_r[..., :-1] - inv_r[..., 1:], torch.full_like(inv_r[..., :1], HUGE)],
                       dim=-1)
    bg_w, _, bg_rgb = composite(sigma, rgb, bg_len)
    bg_depth = torch.sum(bg_w * t, dim=-1)
    return {"rgb": fg_rgb + bg_lambda[..., None] * bg_rgb,
            "depth": fg_depth + bg_lambda * bg_depth,
            "fg_weights": fg_w, "bg_weights": torch.flip(bg_w, dims=(-1,))}


def render(params, mp: dict, rays: dict, generator):
    """Each level's rendering (rgb, depth), coarse first."""
    o, d = rays["origins"], rays["directions"]
    fg_far = intersect_unit_sphere(o, d)
    fg_near = rays["near"][..., 0].expand(fg_far.shape)
    renders, prev = [], None
    for level, n in enumerate(mp.get("cascade_samples", (64, 128))):
        with torch.no_grad():
            if level == 0:
                frac = torch.linspace(0.0, 1.0, n, dtype=o.dtype, device=o.device)
                fg_z = jitter(generator, fg_near[..., None] + (fg_far - fg_near)[..., None] * frac)
                bg_inv_r = jitter(generator, frac.expand(fg_z.shape))
            else:
                fg_new = resample(generator, prev["fg_weights"], fg_z, n)
                fg_z = torch.sort(torch.cat([fg_z, fg_new], dim=-1), dim=-1).values
                bg_new = resample(generator, prev["bg_weights"], bg_inv_r, n)
                bg_inv_r = torch.sort(torch.cat([bg_inv_r, bg_new], dim=-1), dim=-1).values
        prev = render_level(params, mp, level, o, d, fg_far, fg_z, bg_inv_r)
        renders.append(prev)
    return renders


# -------------------------------------------------------------------- loss


def loss(cfg: dict, batch: dict, renders):
    """Total loss of one step: lossmult-weighted mse on rgb and the expected
    depth's mse over the valid rays, each level weighted as the config says."""
    target = batch["rgb"][..., :3]
    lossmult = batch["lossmult"].expand(target.shape)
    denom = torch.clamp(lossmult.sum(), min=1e-8)
    sup = batch["depth_sup"]
    mask = (sup > 0).to(target.dtype)
    rgb_terms, depth_terms = [], []
    for r in renders:
        rgb_terms.append((lossmult * (r["rgb"] - target) ** 2).sum() / denom)
        depth_terms.append(((mask * r["depth"] - mask * sup) ** 2).sum()
                           / torch.clamp(mask.sum(), min=1.0))
    coarse, fine = cfg.get("data_coarse_loss_mult", 0.0), cfg.get("data_loss_mult", 1.0)
    rgb, depth = torch.stack(rgb_terms), torch.stack(depth_terms)
    total = coarse * torch.sum(rgb[:-1]) + fine * rgb[-1]
    return total + cfg["lambda_depth"] * (coarse * torch.sum(depth[:-1]) + fine * depth[-1])
