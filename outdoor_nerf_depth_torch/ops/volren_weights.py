"""Compositing weights from optical depth: CUDA kernels K1a/K1b and plain twins.

Replaces the reference package's Pallas pair in `ops/pallas_volren.py`
(`_fwd_kernel`, `_bwd_kernel`, public op `weights_from_tau`). The kernels
live in `csrc/volren_weights.cu` (one warp per ray, a register scan; see the
note there). Beside them sit plain PyTorch versions of both directions:

  weights_from_tau_plain(tau) -> (w, e)        exclusive cumsum
  weights_from_tau_bwd_plain(g, w, e) -> dtau  reverse exclusive cumsum

`WeightsFromTau` uses the plain versions only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. `FWD_LAUNCHES` and
`BWD_LAUNCHES` count kernel launches, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from outdoor_nerf_depth_torch.ops import cuda_build

TAU_MAX = 1e4  # exp(-1e4) is exactly 0 in f32; an opaque background is +inf
SOURCE = "volren_weights"

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts():
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = 0


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


def _lib():
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.volren_weights_fwd.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
        lib.volren_weights_fwd.restype = i32
        lib.volren_weights_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
        lib.volren_weights_bwd.restype = i32
        lib._argtypes_set = True
    return lib


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


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {code}")


def weights_fwd_cuda(tau: torch.Tensor):
    """K1a on [R, S] float32 CUDA `tau` -> (w, e)."""
    global FWD_LAUNCHES
    _check_2d(tau)
    w, e = torch.empty_like(tau), torch.empty_like(tau)
    with torch.cuda.device(tau.device):
        code = _lib().volren_weights_fwd(
            tau.data_ptr(), w.data_ptr(), e.data_ptr(), tau.shape[0], tau.shape[1], _stream(tau)
        )
    _raise_on(code, "volren_weights_fwd")
    FWD_LAUNCHES += 1
    return w, e


def weights_bwd_cuda(g: torch.Tensor, w: torch.Tensor, e: torch.Tensor):
    """K1b on [R, S] float32 CUDA tensors -> dtau."""
    global BWD_LAUNCHES
    _check_2d(g, w, e)
    dtau = torch.empty_like(g)
    with torch.cuda.device(g.device):
        code = _lib().volren_weights_bwd(
            g.data_ptr(), w.data_ptr(), e.data_ptr(), dtau.data_ptr(),
            g.shape[0], g.shape[1], _stream(g),
        )
    _raise_on(code, "volren_weights_bwd")
    BWD_LAUNCHES += 1
    return dtau


def _require_cpu_or_cuda(x: torch.Tensor):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositing-weights implementation on {x.device}")


class WeightsFromTau(torch.autograd.Function):
    """w = weights_from_tau(tau) over the last axis, with the analytic VJP."""

    @staticmethod
    def forward(ctx, tau):
        _require_cpu_or_cuda(tau)
        shape = tau.shape
        flat = tau.reshape(-1, shape[-1]).to(torch.float32).contiguous()
        if flat.is_cuda:
            w, e = weights_fwd_cuda(flat)
        else:
            w, e = weights_from_tau_plain(flat)
        ctx.save_for_backward(w, e)
        ctx.shape = shape
        return w.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        w, e = ctx.saved_tensors
        g = g.reshape(w.shape).to(torch.float32).contiguous()
        if g.is_cuda:
            dtau = weights_bwd_cuda(g, w, e)
        else:
            dtau = weights_from_tau_bwd_plain(g, w, e)
        return dtau.reshape(ctx.shape)


def weights_from_tau(tau: torch.Tensor) -> torch.Tensor:
    """Compositing weights from metric optical depth. [..., S] -> [..., S]."""
    return WeightsFromTau.apply(tau)
