"""Numerics primitives: safe trig/exp, LR schedule, sorted interpolation.

Port of the reference package's `ops/mathx.py`. The reference brackets each
query with an O(Q*P) comparison and reduction because gathers are slow on a
TPU; here the same brackets come from `torch.searchsorted(right=True)` and a
gather, which keep the tie rule `query >= knot` exactly (the knots are sorted
wherever these are called).
"""

from __future__ import annotations

import math

import torch

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TRIG_PERIOD_CAP = 100.0 * math.pi
_EXP_CLAMP = 88.0  # exp(89) overflows f32.


def as_dtype(dtype) -> torch.dtype:
    """A compute dtype given by name ("float32", "bfloat16") or as a torch dtype."""
    if isinstance(dtype, torch.dtype) and dtype in _COMPUTE_DTYPES.values():
        return dtype
    if dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype!r}: expected one of {sorted(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[dtype]


def _range_reduce(x: torch.Tensor) -> torch.Tensor:
    # Fold large arguments back into a fixed multiple of the period, as the
    # reference does; `%` is a floored modulo in both frameworks.
    return torch.where(x.abs() < _TRIG_PERIOD_CAP, x, x % _TRIG_PERIOD_CAP)


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(_range_reduce(x))


def safe_cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(_range_reduce(x))


class _SafeExp(torch.autograd.Function):
    """exp(min(x, 88)) whose gradient keeps the clamped value's slope."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, max=_EXP_CLAMP))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's gradient at 0, +1 (`torch.abs` gives 0 there).

    It matters where a value starts at exactly 0: NeRF++'s autoexposure
    regularizer at its identity initialization, a density head on dead
    features.
    """
    return torch.where(x >= 0, x, -x)


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp() clamped to stay finite in f32."""
    return _SafeExp.apply(x)


def log_lerp(t: float, v_lo: float, v_hi: float) -> float:
    """Log-linear interpolation between two positive scalars, t clipped to [0,1]."""
    if v_lo <= 0 or v_hi <= 0:
        raise ValueError(f"log_lerp endpoints must be positive, got {v_lo}, {v_hi}")
    lo, hi = math.log(v_lo), math.log(v_hi)
    return math.exp(lo + min(max(t, 0.0), 1.0) * (hi - lo))


def lr_schedule(
    step: int,
    lr_init: float,
    lr_final: float,
    max_steps: int,
    warmup_steps: int = 0,
    warmup_mult: float = 1.0,
) -> float:
    """Log-linear LR decay with an optional sine-eased warmup (host floats)."""
    if warmup_steps > 0:
        ease = math.sin(0.5 * math.pi * min(max(step / warmup_steps, 0.0), 1.0))
        scale = warmup_mult + (1.0 - warmup_mult) * ease
    else:
        scale = 1.0
    return scale * log_lerp(step / max_steps, lr_init, lr_final)


def searchsorted_pair(knots: torch.Tensor, queries: torch.Tensor):
    """Bracketing indices of each query within sorted `knots`.

    Returns (idx_lo, idx_hi) with knots[idx_lo] <= q < knots[idx_hi] for
    in-range q; out-of-range queries clamp both to the first/last knot.
    """
    n = knots.shape[-1]
    lead = torch.broadcast_shapes(knots.shape[:-1], queries.shape[:-1])
    knots = knots.expand(lead + knots.shape[-1:]).contiguous()
    queries = queries.expand(lead + queries.shape[-1:]).contiguous()
    count = torch.searchsorted(knots, queries, right=True)  # #knots <= q
    idx_lo = (count - 1).clamp(min=0)
    idx_hi = count.clamp(max=n - 1)
    return idx_lo, idx_hi


def sorted_interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation where `xp`, `fp` and `x` are sorted."""
    idx_lo, idx_hi = searchsorted_pair(xp, x)
    lead = idx_lo.shape[:-1]
    xp = xp.expand(lead + xp.shape[-1:])
    fp = fp.expand(lead + fp.shape[-1:])
    xp_lo, xp_hi = xp.gather(-1, idx_lo), xp.gather(-1, idx_hi)
    fp_lo, fp_hi = fp.gather(-1, idx_lo), fp.gather(-1, idx_hi)
    t = torch.clip(torch.nan_to_num((x - xp_lo) / (xp_hi - xp_lo), nan=0.0), 0.0, 1.0)
    return fp_lo + t * (fp_hi - fp_lo)
