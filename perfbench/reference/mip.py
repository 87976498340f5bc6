"""Plain PyTorch mip-NeRF 360 train step: the benchmark's frozen reference.

A frozen copy of the math the port's flagship configuration runs
(`models/mipnerf360.py`, `models/mlps.py:ConeFieldMLP`, `ops/spaces.py`,
`ops/stepfuns.py`, `ops/volren.py`, `train/losses.py`, the loss assembly,
clipping and Adam of `train/step.py`), cut to the options that
configuration uses: no GLO, exposure, normals or noise; the compositing
weights by an exclusive cumsum instead of the port's CUDA kernel. It
imports nothing of the program. Parameters are a flat dict named as the
port's modules name theirs, initialized from the seed in the port's order
(He-uniform weights, zero biases, the NeRF MLP before the proposal MLP).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = torch.finfo(torch.float32).eps
OPENCV_TO_OPENGL3 = np.diag([1.0, -1.0, -1.0])


# ------------------------------------------------------------------ params


def mlp_layers(params: dict, is_prop: bool, enc_dim: int):
    """[(name, fan_in, fan_out)] of one cone field MLP, in construction order."""
    depth, width = params.get("net_depth", 8), params.get("net_width", 256)
    skip = params.get("skip_layer", 4)
    out, x = [], enc_dim
    for i in range(depth):
        out.append((f"trunk{i}", x, width))
        x = width + (enc_dim if i % skip == 0 and i > 0 else 0)
    out.append(("density_head", x, 1))
    if is_prop:
        return out
    bottleneck = params.get("bottleneck_width", 256)
    out.append(("bottleneck", x, bottleneck))
    y = bottleneck + 3 + 6 * params.get("deg_view", 4)
    for i in range(params.get("net_depth_viewdirs", 1)):
        width_v = params.get("net_width_viewdirs", 128)
        out.append((f"view{i}", y, width_v))
        y = width_v
    out.append(("rgb_head", y, 3))
    return out


def init_params(model_params: dict, seed: int) -> dict:
    """Flat {name: float32 tensor} on the CPU, drawn as the port draws them."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for prefix, is_prop in (("nerf_mlp", False), ("prop_mlp", True)):
        p = model_params.get("prop_mlp_params" if is_prop else "nerf_mlp_params") or {}
        enc = 2 * sphere_basis().shape[1] * (p.get("max_deg_point", 12) - p.get("min_deg_point", 0))
        for name, fan_in, fan_out in mlp_layers(p, is_prop, enc):
            bound = math.sqrt(3.0) * (math.sqrt(2.0) / math.sqrt(fan_in))
            w = torch.empty(fan_out, fan_in).uniform_(-bound, bound, generator=gen)
            out[f"{prefix}.{name}.weight"] = w
            out[f"{prefix}.{name}.bias"] = torch.zeros(fan_out)
    return out


# ------------------------------------------------------------------ spaces


def _tessellation(subdivisions: int) -> np.ndarray:
    phi = (np.sqrt(5.0) + 1.0) / 2.0
    verts = np.array([(-1, 0, phi), (1, 0, phi), (-1, 0, -phi), (1, 0, -phi),
                      (0, phi, 1), (0, phi, -1), (0, -phi, 1), (0, -phi, -1),
                      (phi, 1, 0), (-phi, 1, 0), (phi, -1, 0), (-phi, -1, 0)],
                     dtype=np.float64) / np.sqrt(phi + 2.0)
    faces = np.array([(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
                      (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
                      (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
                      (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11)])
    v = subdivisions
    bary = np.array([(i, j, v - i - j) for i in range(v + 1) for j in range(v + 1 - i)],
                    dtype=np.float64) / v
    pts = np.concatenate([bary @ verts[f] for f in faces], axis=0)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, -1)
    first = np.array([np.argwhere(row <= 1e-4).min() for row in d2])
    return pts[np.unique(first)]


def sphere_basis(subdivisions: int = 2) -> torch.Tensor:
    """[3, m] directions of the icosahedral basis, antipodes removed."""
    verts = _tessellation(subdivisions)
    d2 = np.sum((verts[:, None, :] + verts[None, :, :]) ** 2, -1)
    verts = verts[np.any(np.triu(d2 < 1e-4), axis=1)]
    return torch.tensor(verts[:, ::-1].T.copy(), dtype=torch.float32)


def contract_gaussian(x, cov):
    """Scene contraction of the means and its Jacobian applied to the covariances."""
    r_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=EPS)
    r = torch.sqrt(r_sq)
    scale = (2.0 * r - 1.0) / r_sq
    inside = r_sq <= 1.0
    radial = 2.0 * (1.0 - r) / (r_sq * r_sq)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    jac = scale[..., None] * eye + radial[..., None] * (x[..., :, None] * x[..., None, :])
    jac = torch.where(inside[..., None], eye.expand(jac.shape), jac)
    return torch.where(inside, x, scale * x), jac @ cov @ jac.transpose(-1, -2)


def _range_reduce(x):
    cap = 100.0 * math.pi
    return torch.where(x.abs() < cap, x, x % cap)


def integrated_pos_enc(mean, var, min_deg: int, max_deg: int):
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype, device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    mean_s = (mean[..., None, :] * scales[:, None]).reshape(shape)
    var_s = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    phases = torch.cat([mean_s, mean_s + 0.5 * math.pi], dim=-1)
    return torch.exp(-0.5 * torch.cat([var_s, var_s], dim=-1)) * torch.sin(_range_reduce(phases))


def pos_enc(x, max_deg: int):
    scales = 2.0 ** torch.arange(0, max_deg, dtype=x.dtype, device=x.device)
    xs = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([xs, xs + 0.5 * math.pi], dim=-1))], dim=-1)


# --------------------------------------------------------------- stepfuns


def searchsorted_pair(knots, queries):
    n = knots.shape[-1]
    lead = torch.broadcast_shapes(knots.shape[:-1], queries.shape[:-1])
    knots = knots.expand(lead + knots.shape[-1:]).contiguous()
    queries = queries.expand(lead + queries.shape[-1:]).contiguous()
    count = torch.searchsorted(knots, queries, right=True)
    return (count - 1).clamp(min=0), count.clamp(max=n - 1)


def sorted_interp(x, xp, fp):
    lo, hi = searchsorted_pair(xp, x)
    lead = lo.shape[:-1]
    xp, fp = xp.expand(lead + xp.shape[-1:]), fp.expand(lead + fp.shape[-1:])
    xp_lo, xp_hi, fp_lo, fp_hi = xp.gather(-1, lo), xp.gather(-1, hi), fp.gather(-1, lo), fp.gather(-1, hi)
    t = torch.clip(torch.nan_to_num((x - xp_lo) / (xp_hi - xp_lo), nan=0.0), 0.0, 1.0)
    return fp_lo + t * (fp_hi - fp_lo)


def max_dilate_weights(t, w, dilation, domain):
    p = w / torch.clamp(torch.diff(t, dim=-1), min=EPS**2)
    lo, hi = t[..., :-1] - dilation, t[..., 1:] + dilation
    t_d = torch.clip(torch.sort(torch.cat([t, lo, hi], dim=-1), dim=-1).values, *domain)
    covered = (lo[..., None, :] <= t_d[..., None]) & (hi[..., None, :] > t_d[..., None])
    p_d = torch.where(covered, p[..., None, :], torch.zeros((), dtype=w.dtype, device=w.device))
    p_d = p_d.amax(dim=-1)[..., :-1]
    w_d = p_d * torch.diff(t_d, dim=-1)
    return t_d, w_d / torch.clamp(w_d.sum(dim=-1, keepdim=True), min=EPS**2)


def integrate_weights(w):
    interior = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1.0)
    pad = torch.zeros_like(w[..., :1])
    return torch.cat([pad, interior, torch.ones_like(pad)], dim=-1)


def sample_intervals(generator, t, logits, n: int, domain):
    """Stratified, single-jittered centres of n intervals drawn from
    softmax(logits) on the edges t, widened into n + 1 edges."""
    u_ceil = EPS + (1.0 - EPS) / n
    span = (1.0 - u_ceil) / (n - 1) - EPS
    base = torch.linspace(0.0, 1.0 - u_ceil, n, dtype=t.dtype, device=t.device)
    if generator is None:
        pad = 1.0 / (2 * n)
        u = torch.linspace(pad, 1.0 - pad - EPS, n, dtype=t.dtype,
                           device=t.device).expand(t.shape[:-1] + (n,))
    else:
        jitter = torch.rand(t.shape[:-1] + (1,), generator=generator, dtype=t.dtype,
                            device=t.device)
        u = base + jitter * span
    centers = sorted_interp(u, integrate_weights(torch.softmax(logits, dim=-1)), t)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], dim=-1)


def outer_envelope_loss(t, w, t_prop, w_prop):
    cum = torch.cat([torch.zeros_like(w_prop[..., :1]), torch.cumsum(w_prop, dim=-1)], dim=-1)
    lo, hi = searchsorted_pair(t_prop, t)
    cum = cum.expand(lo.shape[:-1] + cum.shape[-1:])
    w_outer = cum.gather(-1, hi)[..., 1:] - cum.gather(-1, lo)[..., :-1]
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + EPS)


def distortion(t, w):
    mid = 0.5 * (t[..., 1:] + t[..., :-1])
    pair = (mid[..., :, None] - mid[..., None, :]).abs()
    inter = torch.sum(w * torch.sum(w[..., None, :] * pair, dim=-1), dim=-1)
    return inter + torch.sum(w**2 * torch.diff(t, dim=-1), dim=-1) / 3.0


# ----------------------------------------------------------------- volren


def cast_cones(tdist, origins, directions, radii):
    """Conical frusta of the intervals as Gaussians: means [..., S, 3], covs [..., S, 3, 3]."""
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    mu, hw = 0.5 * (t0 + t1), 0.5 * (t1 - t0)
    denom = torch.clamp(3.0 * mu**2 + hw**2, min=EPS)
    t_mean = mu + (2.0 * mu * hw**2) / denom
    t_var = hw**2 / 3.0 - (4.0 / 15.0) * hw**4 * (12.0 * mu**2 - hw**2) / denom**2
    r_var = radii**2 * (mu**2 / 4.0 + (5.0 / 12.0) * hw**2 - (4.0 / 15.0) * hw**4 / denom)
    d = directions
    mean = d[..., None, :] * t_mean[..., None]
    d_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    perp = eye - d[..., :, None] * (d / d_sq)[..., None, :]
    cov = (t_var[..., None, None] * outer[..., None, :, :]
           + r_var[..., None, None] * perp[..., None, :, :])
    return mean + origins[..., None, :], cov


def weights_from_tau(tau):
    """w_i = exp(-sum_{j<i} tau_j) (1 - exp(-tau_i))."""
    tau = torch.clamp(tau, max=1e4)
    p = torch.cat([torch.zeros_like(tau[..., :1]), torch.cumsum(tau[..., :-1], dim=-1)], dim=-1)
    return torch.exp(-p) - torch.exp(-(p + tau))


# ------------------------------------------------------------------ model


def dense(params, name, x):
    return F.linear(x, params[name + ".weight"], params[name + ".bias"])


def field(params, prefix, mlp_params, is_prop, means, covs, viewdirs, basis):
    means, covs = contract_gaussian(means, covs)
    lifted_mean = means @ basis
    lifted_var = torch.sum(basis * (covs @ basis), dim=-2)
    x = integrated_pos_enc(lifted_mean, lifted_var, mlp_params.get("min_deg_point", 0),
                           mlp_params.get("max_deg_point", 12))
    skip_in, skip = x, mlp_params.get("skip_layer", 4)
    for i in range(mlp_params.get("net_depth", 8)):
        x = F.relu(dense(params, f"{prefix}.trunk{i}", x))
        if i % skip == 0 and i > 0:
            x = torch.cat([x, skip_in], dim=-1)
    density = F.softplus(dense(params, f"{prefix}.density_head", x)[..., 0]
                         + mlp_params.get("density_bias", -1.0))
    if is_prop:
        return density, torch.zeros_like(means)
    b = dense(params, f"{prefix}.bottleneck", x)
    enc = pos_enc(viewdirs, mlp_params.get("deg_view", 4))
    y = torch.cat([b, enc[..., None, :].expand(b.shape[:-1] + enc.shape[-1:])], dim=-1)
    for i in range(mlp_params.get("net_depth_viewdirs", 1)):
        y = F.relu(dense(params, f"{prefix}.view{i}", y))
    pad = mlp_params.get("rgb_padding", 0.001)
    rgb = torch.sigmoid(mlp_params.get("rgb_premultiplier", 1.0) * dense(params, f"{prefix}.rgb_head", y)
                        + mlp_params.get("rgb_bias", 0.0))
    return density, rgb * (1.0 + 2.0 * pad) - pad


def render(params, mp: dict, rays: dict, train_frac: float, generator, basis):
    """The levels' renderings (rgb, distance_mean) and histories (sdist, weights)."""
    o, d, viewdirs, radii = rays["origins"], rays["directions"], rays["viewdirs"], rays["radii"]
    near, far = rays["near"], rays["far"]
    s_near_t, s_far_t = 1.0 / near, 1.0 / far  # the reciprocal ray-distance warp
    s_to_t = lambda s: 1.0 / (s * s_far_t + (1.0 - s) * s_near_t)
    sdist = torch.cat([torch.zeros_like(near), torch.ones_like(far)], dim=-1)
    weights = torch.ones_like(near)
    levels = mp.get("num_levels", 3)
    prod, renders, history = 1, [], []
    slope = mp.get("anneal_slope", 10.0)
    anneal = (slope * train_frac) / ((slope - 1.0) * train_frac + 1.0)
    for level in range(levels):
        is_prop = level < levels - 1
        n = mp["num_prop_samples"] if is_prop else mp["num_nerf_samples"]
        dilation = mp.get("dilation_bias", 0.0025) + mp.get("dilation_multiplier", 0.5) / prod
        prod *= n
        with torch.no_grad():
            if level > 0:
                sdist, weights = max_dilate_weights(sdist, weights, dilation, (0.0, 1.0))
                sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
            logits = torch.where(sdist[..., 1:] > sdist[..., :-1], anneal * torch.log(weights),
                                 torch.full((), float("-inf"), dtype=weights.dtype,
                                            device=weights.device))
            sdist = sample_intervals(generator, sdist, logits, n, (0.0, 1.0))
        tdist = s_to_t(sdist)
        means, covs = cast_cones(tdist, o, d, radii)
        prefix = "prop_mlp" if is_prop else "nerf_mlp"
        mlp_params = mp.get("prop_mlp_params" if is_prop else "nerf_mlp_params") or {}
        density, rgb = field(params, prefix, mlp_params, is_prop, means, covs, viewdirs, basis)
        tau = density * torch.diff(tdist, dim=-1) * torch.linalg.norm(d[..., None, :], dim=-1)
        tau = torch.cat([tau[..., :-1], torch.full_like(tau[..., -1:], float("inf"))], dim=-1)
        weights = weights_from_tau(tau)
        acc = weights.sum(dim=-1)
        out_rgb = torch.sum(weights[..., None] * rgb, dim=-2) + torch.clamp(1.0 - acc[..., None], min=0.0)
        t_mid = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
        mean_log = torch.sum(weights * torch.log(t_mid), dim=-1) / torch.clamp(acc, min=EPS)
        dist = torch.clip(torch.nan_to_num(torch.exp(mean_log), nan=float("inf")),
                          tdist[..., 0], tdist[..., -1])
        renders.append({"rgb": out_rgb, "distance_mean": dist})
        history.append({"sdist": sdist, "weights": weights})
    return renders, history


def loss(cfg: dict, batch: dict, renders, history):
    """Total loss of one step (charb rgb on the last level, mse depth, interlevel, distortion)."""
    pad = cfg.get("charb_padding", 0.001)
    target = batch["rgb"][..., :3]
    lossmult = batch["lossmult"].expand(target.shape)
    denom = torch.clamp(lossmult.sum(), min=1e-8)
    rgb_terms, depth_terms = [], []
    for r in renders:
        rgb_terms.append((lossmult * torch.sqrt((r["rgb"] - target) ** 2 + pad**2)).sum() / denom)
        sup = batch["depth_sup"]
        mask = (sup > 0).to(r["distance_mean"].dtype)
        depth_terms.append(((mask * r["distance_mean"] - mask * sup) ** 2).mean())
    coarse, fine = cfg.get("data_coarse_loss_mult", 0.0), cfg.get("data_loss_mult", 1.0)
    total = coarse * torch.sum(torch.stack(rgb_terms[:-1])) + fine * rgb_terms[-1]
    total = total + cfg["lambda_depth"] * (coarse * torch.sum(torch.stack(depth_terms[:-1]))
                                           + fine * depth_terms[-1])
    t, w = history[-1]["sdist"].detach(), history[-1]["weights"].detach()
    inter = sum(torch.mean(outer_envelope_loss(t, w, h["sdist"], h["weights"]))
                for h in history[:-1])
    total = total + cfg.get("interlevel_loss_mult", 1.0) * inter
    total = total + cfg.get("distortion_loss_mult", 0.01) * torch.mean(
        distortion(history[-1]["sdist"], history[-1]["weights"]))
    return total


def groups(params: dict):
    """Top-level modules, each clipped on its own."""
    return {name: [k for k in params if k.startswith(name + ".")]
            for name in ("nerf_mlp", "prop_mlp")}
