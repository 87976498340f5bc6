"""Step-function (piecewise-constant 1D density) toolkit.

Port of the reference package's `ops/stepfuns.py`: `t` holds sorted bin
edges ([..., n+1]) and `w` per-bin weights ([..., n]). Stratified jitter
comes from an explicit `torch.Generator` instead of a PRNG key.
"""

from __future__ import annotations

from typing import Optional

import torch

from outdoor_nerf_depth_torch.ops import mathx
from outdoor_nerf_depth_torch.parallel import mesh

_EPS = torch.finfo(torch.float32).eps
_INF = float("inf")


def _pad_zero_left(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[..., :1]), x], dim=-1)


def query(tq, t, y, fill=0.0):
    """Evaluate the step function (t, y) at points tq (`fill` outside [t0, tn])."""
    idx_lo, idx_hi = mathx.searchsorted_pair(t, tq)
    inside = idx_lo != idx_hi
    y = y.expand(idx_lo.shape[:-1] + y.shape[-1:])
    # Past the last edge idx_lo is n, one past y; those queries are filled.
    vals = y.gather(-1, idx_lo.clamp(max=y.shape[-1] - 1))
    return torch.where(inside, vals, torch.as_tensor(fill, dtype=y.dtype))


def inner_outer(t_query, t, w):
    """Inner/outer measures of (t, w) accumulated onto the bins of t_query."""
    cum = _pad_zero_left(torch.cumsum(w, dim=-1))
    idx_lo, idx_hi = mathx.searchsorted_pair(t, t_query)
    cum = cum.expand(idx_lo.shape[:-1] + cum.shape[-1:])
    cum_lo = cum.gather(-1, idx_lo)
    cum_hi = cum.gather(-1, idx_hi)
    outer = cum_hi[..., 1:] - cum_lo[..., :-1]
    inner = torch.where(
        idx_hi[..., :-1] <= idx_lo[..., 1:],
        cum_lo[..., 1:] - cum_hi[..., :-1],
        torch.zeros((), dtype=cum.dtype, device=cum.device),
    )
    return inner, outer


def outer_envelope_loss(t, w, t_prop, w_prop, eps=_EPS):
    """Proposal-supervision loss: penalize proposal mass below the NeRF mass."""
    _, w_outer = inner_outer(t, t_prop, w_prop)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + eps)


def weights_to_density(t, w, eps=_EPS**2):
    return w / torch.clamp(torch.diff(t, dim=-1), min=eps)


def density_to_weights(t, p):
    return p * torch.diff(t, dim=-1)


def max_dilate(t, w, dilation, domain=(-_INF, _INF)):
    """Morphological max-dilation of a non-negative step function by `dilation`."""
    lo = t[..., :-1] - dilation
    hi = t[..., 1:] + dilation
    t_d = torch.sort(torch.cat([t, lo, hi], dim=-1), dim=-1).values
    t_d = torch.clip(t_d, *domain)
    covered = (lo[..., None, :] <= t_d[..., None]) & (hi[..., None, :] > t_d[..., None])
    w_d = torch.where(covered, w[..., None, :], torch.zeros((), dtype=w.dtype, device=w.device))
    return t_d, w_d.amax(dim=-1)[..., :-1]


def max_dilate_weights(t, w, dilation, domain=(-_INF, _INF), renormalize=False, eps=_EPS**2):
    """Dilate a weight histogram in density space, then convert back."""
    p = weights_to_density(t, w)
    t_d, p_d = max_dilate(t, p, dilation, domain=domain)
    w_d = density_to_weights(t_d, p_d)
    if renormalize:
        w_d = w_d / torch.clamp(w_d.sum(dim=-1, keepdim=True), min=eps)
    return t_d, w_d


def integrate_weights(w):
    """CDF at the bin edges of a weight vector assumed to sum to 1."""
    interior = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1.0)
    pad = torch.zeros_like(w[..., :1])
    return torch.cat([pad, interior, torch.ones_like(pad)], dim=-1)


def invert_cdf(u, t, w_logits):
    """Map uniform variates u in [0,1) through the inverse CDF of (t, softmax(w))."""
    w = torch.softmax(w_logits, dim=-1)
    return mathx.sorted_interp(u, integrate_weights(w), t)


def _linspace(start: float, stop: float, n: int, like: torch.Tensor):
    return torch.linspace(start, stop, n, dtype=like.dtype, device=like.device)


def sample(
    generator: Optional[torch.Generator],
    t,
    w_logits,
    num_samples: int,
    single_jitter: bool = False,
    deterministic_center: bool = False,
):
    """Draw point samples from the step-function PDF (t, softmax(w_logits)).

    With `generator=None` the samples linspace the CDF; otherwise each sample
    is jittered inside its slab (one shared jitter per ray with
    `single_jitter`), drawn from `generator` on the tensors' device.
    """
    if generator is None:
        if deterministic_center:
            pad = 1.0 / (2 * num_samples)
            u = _linspace(pad, 1.0 - pad - _EPS, num_samples, t)
        else:
            u = _linspace(0.0, 1.0 - _EPS, num_samples, t)
        u = u.expand(t.shape[:-1] + (num_samples,))
    else:
        u_ceil = _EPS + (1.0 - _EPS) / num_samples
        jitter_span = (1.0 - u_ceil) / (num_samples - 1) - _EPS
        n_jitters = 1 if single_jitter else num_samples
        base = _linspace(0.0, 1.0 - u_ceil, num_samples, t)
        jitter = mesh.rand(
            t.shape[:-1] + (n_jitters,), generator=generator, dtype=t.dtype, device=t.device
        )
        u = base + jitter * jitter_span
    return invert_cdf(u, t, w_logits)


def sample_intervals(
    generator: Optional[torch.Generator],
    t,
    w_logits,
    num_samples: int,
    single_jitter: bool = False,
    domain=(-_INF, _INF),
):
    """Sample `num_samples` intervals (n+1 edges) from a step-function PDF."""
    if num_samples <= 1:
        raise ValueError(f"need num_samples > 1, got {num_samples}")
    centers = sample(
        generator, t, w_logits, num_samples,
        single_jitter=single_jitter, deterministic_center=True,
    )
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], dim=-1)


def distortion_loss(t, w):
    """mip-NeRF 360 distortion: E_{i,j}[w_i w_j |mid_i - mid_j|] + intra term."""
    mid = 0.5 * (t[..., 1:] + t[..., :-1])
    pair = (mid[..., :, None] - mid[..., None, :]).abs()
    inter = torch.sum(w * torch.sum(w[..., None, :] * pair, dim=-1), dim=-1)
    intra = torch.sum(w**2 * torch.diff(t, dim=-1), dim=-1) / 3.0
    return inter + intra


def interval_distortion(t0_lo, t0_hi, t1_lo, t1_hi):
    """Closed-form E|x - y| for x~U[t0_lo,t0_hi], y~U[t1_lo,t1_hi]."""
    disjoint_d = (0.5 * (t1_lo + t1_hi) - 0.5 * (t0_lo + t0_hi)).abs()
    numer = 2.0 * (
        torch.minimum(t0_hi, t1_hi) ** 3 - torch.maximum(t0_lo, t1_lo) ** 3
    ) + 3.0 * (
        t1_hi * t0_hi * (t1_hi - t0_hi).abs()
        + t1_lo * t0_lo * (t1_lo - t0_lo).abs()
        + t1_hi * t0_lo * (t0_lo - t1_hi)
        + t1_lo * t0_hi * (t1_lo - t0_hi)
    )
    overlap_d = numer / (6.0 * (t0_hi - t0_lo) * (t1_hi - t1_lo))
    disjoint = (t0_lo > t1_hi) | (t1_lo > t0_hi)
    return torch.where(disjoint, disjoint_d, overlap_d)


def weighted_percentile(t, w, ps):
    """Percentiles of a step function whose weights sum to 1."""
    cdf = integrate_weights(w)
    q = torch.as_tensor(ps, dtype=cdf.dtype, device=cdf.device) / 100.0
    return mathx.sorted_interp(q.expand(t.shape[:-1] + (len(ps),)), cdf, t)
