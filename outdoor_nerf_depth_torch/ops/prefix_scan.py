"""Inclusive prefix sums of narrow arrays: CUDA kernels K2a and K2b and plain twins.

K2a (`cumsum`, [N, lanes] along axis 0) replaces the reference package's
Pallas kernel `_scan_kernel` in `ops/pallas_scan.py` (public op `cumsum`),
the scan inside the Instant-NGP hash-table gradient: the oct layout's one
scan over all levels (`ops/hashgrid.py:_oct_table_grad`) and the per-level
`_oct_split_row_sums` of the osplit backward probe. K2b (`cumsum_batched`,
[B, N, lanes] along axis 1, the carry reset at each batch element) replaces
`_scan_kernel_batched` (public op `cumsum_batched`): the osplit layout's
table gradient scans all its levels with it in one launch
(`ops/hashgrid.py:_oct_split_table_grad`), and the osplit backward probe
(`probes/osplit_bwd.py`) times it against 16 separate scans.
Both are one kernel, `csrc/prefix_scan.cu`: a single-pass scan with
decoupled look-back, K2a being its batch of 1 (see the note there). Its
f32 carries are summed in an order that depends on timing, so two calls on
one input may differ by a few ulps of the running |x| sum. `lanes` must
divide 128, as in the reference; any N and any dtype work: like the
reference, both accumulate in f32 and return x's dtype (the CUDA wrappers
cast to f32 before the kernel and back after it).

`cumsum` and `cumsum_batched` use the plain version, `torch.cumsum` in f32,
only for a tensor on the CPU; for a CUDA tensor they launch the kernel or
raise (`cuda_build.use_kernel`). `cuda_build.launches()` counts the launches
of K2a and K2b, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import torch

from outdoor_nerf_depth_torch.ops import cuda_build
from outdoor_nerf_depth_torch.ops.cuda_build import I32, I64, PTR

LANE = 128
TILE_ELEMS = 16384  # elements per tile of the kernel (kTileElems in the source,
                    # which refuses a scratch sized for another tile)
SOURCE = "prefix_scan"
K2A, K2B = (cuda_build.Kernel(kid, SOURCE, "prefix_scan_batched_f32", PTR, PTR, PTR, I64, I64,
                              I32, I64) for kid in ("K2a", "K2b"))


def _check_lanes(x: torch.Tensor, ndim: int = 2):
    if x.dim() != ndim:
        layout = "[N, lanes]" if ndim == 2 else "[B, N, lanes]"
        raise ValueError(f"prefix scan takes a {ndim}-D {layout} array, got {tuple(x.shape)}")
    lanes = x.shape[-1]
    if lanes == 0 or LANE % lanes:
        raise ValueError(f"lanes must divide {LANE}, got {lanes}")


def _check_kernel_input(x: torch.Tensor):
    if not (x.is_cuda and x.is_contiguous()):
        raise ValueError(f"kernel takes a contiguous CUDA tensor, got one on {x.device}")


def tile_plan(batch: int, rows: int, lanes: int):
    """(tiles per batch element, scratch words) of the kernel's launch.

    A tile holds TILE_ELEMS // lanes rows of one batch element; the scratch
    is one 64-bit status word per tile and lane, then the ticket counter.
    """
    tiles = -(-rows // (TILE_ELEMS // lanes))
    return tiles, batch * tiles * lanes + 1


def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum along axis 0, accumulated in float32, in x's dtype."""
    return torch.cumsum(x.to(torch.float32), dim=0).to(x.dtype)


def _launch(kernel: cuda_build.Kernel, x: torch.Tensor, out: torch.Tensor, shape):
    """The kernel from a non-empty contiguous [B, N, lanes] float32 CUDA
    tensor into `out`, of the same shape; `shape`, the caller's input
    shape, is the launch key."""
    batch, rows, lanes = x.shape
    tiles, words = tile_plan(batch, rows, lanes)
    # Status words and ticket start at zero on every call (one memset).
    scratch = torch.zeros(words, dtype=torch.int64, device=x.device)
    kernel(x.device, x.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, rows, lanes, tiles,
           key=lambda: tuple(shape))


def cumsum_cuda(x: torch.Tensor) -> torch.Tensor:
    """K2a on a contiguous [N, lanes] CUDA tensor, accumulated in f32, in x's dtype."""
    _check_lanes(x)
    _check_kernel_input(x)
    x32 = x.to(torch.float32)
    out = torch.empty_like(x32)
    if x.numel():
        _launch(K2A, x32[None], out[None], x.shape)
    return out.to(x.dtype)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 of [N, lanes] (lanes | 128)."""
    _check_lanes(x)
    if cuda_build.use_kernel(x, "prefix-scan"):
        return cumsum_cuda(x.contiguous())
    return cumsum_plain(x)


def cumsum_batched_plain(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum along axis 1, accumulated in float32, in x's dtype."""
    return torch.cumsum(x.to(torch.float32), dim=1).to(x.dtype)


def cumsum_batched_cuda(x: torch.Tensor) -> torch.Tensor:
    """K2b on a contiguous [B, N, lanes] CUDA tensor, accumulated in f32, in x's dtype."""
    _check_lanes(x, ndim=3)
    _check_kernel_input(x)
    x32 = x.to(torch.float32)
    out = torch.empty_like(x32)
    if x.numel():
        _launch(K2B, x32, out, x.shape)
    return out.to(x.dtype)


def cumsum_batched(x: torch.Tensor) -> torch.Tensor:
    """Independent inclusive prefix sums along axis 1 of [B, N, lanes] (lanes | 128)."""
    _check_lanes(x, ndim=3)
    if cuda_build.use_kernel(x, "prefix-scan"):
        return cumsum_batched_cuda(x.contiguous())
    return cumsum_batched_plain(x)
