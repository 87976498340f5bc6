"""Compositing weights from optical depth: CUDA kernels K1a/K1b and plain twins.

Replaces the reference package's Pallas pair in `ops/pallas_volren.py`
(`_fwd_kernel`, `_bwd_kernel`, public op `weights_from_tau`). The kernels
live in `csrc/volren_weights.cu` (one warp per ray, a register scan; see the
note there). Beside them sit plain PyTorch versions of both directions:

  weights_from_tau_plain(tau) -> (w, e)        exclusive cumsum
  weights_from_tau_bwd_plain(g, w, e) -> dtau  reverse exclusive cumsum

`WeightsFromTau` uses the plain versions only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises (`cuda_build.use_kernel`).
`cuda_build.launches()` counts the launches of K1a and K1b, so a run can
show that it went through the kernels.
"""

from __future__ import annotations

import torch

from outdoor_nerf_depth_torch.ops import cuda_build
from outdoor_nerf_depth_torch.ops.cuda_build import I32, PTR

TAU_MAX = 1e4  # exp(-1e4) is exactly 0 in f32; an opaque background is +inf
SOURCE = "volren_weights"
K1A = cuda_build.Kernel("K1a", SOURCE, "volren_weights_fwd", PTR, PTR, PTR, I32, I32)
K1B = cuda_build.Kernel("K1b", SOURCE, "volren_weights_bwd", PTR, PTR, PTR, PTR, I32, I32)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(x[..., :-1], dim=-1)], dim=-1)


def weights_from_tau_plain(tau: torch.Tensor):
    """w_i = exp(-P_i) - exp(-(P_i + tau_i)) and e_i = exp(-(P_i + tau_i))."""
    tau = torch.clamp(tau, max=TAU_MAX)
    p = _exclusive_cumsum(tau)
    e = torch.exp(-(p + tau))
    return torch.exp(-p) - e, e


def weights_from_tau_bwd_plain(g, w, e):
    """dtau_k = g_k e_k - sum_{i>k} g_i w_i."""
    gw = g * w
    suffix = torch.flip(_exclusive_cumsum(torch.flip(gw, dims=(-1,))), dims=(-1,))
    return g * e - suffix


def _check_2d(*xs: torch.Tensor):
    for x in xs:
        if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 2 and x.is_contiguous()):
            raise ValueError(
                f"kernel takes contiguous 2-D float32 CUDA tensors, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if x.shape != xs[0].shape:
            raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(xs[0].shape)}")
    if xs[0].numel() >= 2**31:
        raise ValueError("kernel indexes rays and samples with 32-bit ints")


def weights_fwd_cuda(tau: torch.Tensor):
    """K1a on [R, S] float32 CUDA `tau` -> (w, e)."""
    _check_2d(tau)
    w, e = torch.empty_like(tau), torch.empty_like(tau)
    K1A(tau.device, tau.data_ptr(), w.data_ptr(), e.data_ptr(), tau.shape[0], tau.shape[1],
        key=lambda: tuple(tau.shape))
    return w, e


def weights_bwd_cuda(g: torch.Tensor, w: torch.Tensor, e: torch.Tensor):
    """K1b on [R, S] float32 CUDA tensors -> dtau."""
    _check_2d(g, w, e)
    dtau = torch.empty_like(g)
    K1B(g.device, g.data_ptr(), w.data_ptr(), e.data_ptr(), dtau.data_ptr(), g.shape[0],
        g.shape[1], key=lambda: tuple(g.shape))
    return dtau


class WeightsFromTau(torch.autograd.Function):
    """w = weights_from_tau(tau) over the last axis, with the analytic VJP."""

    @staticmethod
    def forward(ctx, tau):
        kernel = cuda_build.use_kernel(tau, "compositing-weights")
        shape = tau.shape
        flat = tau.reshape(-1, shape[-1]).to(torch.float32).contiguous()
        w, e = weights_fwd_cuda(flat) if kernel else weights_from_tau_plain(flat)
        ctx.save_for_backward(w, e)
        ctx.shape = shape
        return w.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        w, e = ctx.saved_tensors
        g = g.reshape(w.shape).to(torch.float32).contiguous()
        if cuda_build.use_kernel(g, "compositing-weights"):
            dtau = weights_bwd_cuda(g, w, e)
        else:
            dtau = weights_from_tau_bwd_plain(g, w, e)
        return dtau.reshape(ctx.shape)


def weights_from_tau(tau: torch.Tensor) -> torch.Tensor:
    """Compositing weights from metric optical depth. [..., S] -> [..., S]."""
    return WeightsFromTau.apply(tau)
