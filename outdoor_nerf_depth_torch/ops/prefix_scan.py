"""Inclusive prefix sums of narrow arrays: CUDA kernels K2a and K2b and plain twins.

K2a (`cumsum`, [N, lanes] along axis 0) replaces the reference package's
Pallas kernel `_scan_kernel` in `ops/pallas_scan.py` (public op `cumsum`),
the scan inside the Instant-NGP hash-table gradient
(`ops/hashgrid.py:_oct_split_row_sums`). K2b (`cumsum_batched`,
[B, N, lanes] along axis 1, the carry reset at each batch element) replaces
`_scan_kernel_batched` (public op `cumsum_batched`), which the osplit
backward probe (`probes/osplit_bwd.py`) times against 16 separate scans.
Both are one kernel, `csrc/prefix_scan.cu`: a single-pass scan with
decoupled look-back, K2a being its batch of 1 (see the note there). Its
f32 carries are summed in an order that depends on timing, so two calls on
one input may differ by a few ulps of the running |x| sum. `lanes` must
divide 128, as in the reference; any N works.

`cumsum` and `cumsum_batched` use the plain version, `torch.cumsum` in f32,
only for a tensor on the CPU; for a CUDA tensor they launch the kernel or
raise. `LAUNCHES` (K2a) and `BATCHED_LAUNCHES` (K2b) count kernel launches,
so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from outdoor_nerf_depth_torch.ops import cuda_build

LANE = 128
TILE_ELEMS = 16384  # elements per tile of the kernel (kTileElems in the source,
                    # which refuses a scratch sized for another tile)
SOURCE = "prefix_scan"

LAUNCHES = 0
BATCHED_LAUNCHES = 0


def reset_launch_counts():
    global LAUNCHES, BATCHED_LAUNCHES
    LAUNCHES = 0
    BATCHED_LAUNCHES = 0


def _check_lanes(x: torch.Tensor, ndim: int = 2):
    if x.dim() != ndim:
        layout = "[N, lanes]" if ndim == 2 else "[B, N, lanes]"
        raise ValueError(f"prefix scan takes a {ndim}-D {layout} array, got {tuple(x.shape)}")
    lanes = x.shape[-1]
    if lanes == 0 or LANE % lanes:
        raise ValueError(f"lanes must divide {LANE}, got {lanes}")


def _check_kernel_input(x: torch.Tensor):
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError(
            f"kernel takes a contiguous float32 CUDA tensor, got {x.dtype} on {x.device}"
        )


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


def _lib():
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.prefix_scan_batched_f32.argtypes = [ptr, ptr, ptr, i64, i64, i32, i64, ptr]
        lib.prefix_scan_batched_f32.restype = i32
        lib._argtypes_set = True
    return lib


def _launch(x: torch.Tensor, out: torch.Tensor):
    """The kernel from a non-empty contiguous [B, N, lanes] float32 CUDA
    tensor into `out`, of the same shape."""
    batch, rows, lanes = x.shape
    tiles, words = tile_plan(batch, rows, lanes)
    # Status words and ticket start at zero on every call (one memset).
    scratch = torch.zeros(words, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib().prefix_scan_batched_f32(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, rows, lanes, tiles,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"prefix_scan launch failed: cudaError {code}")


def cumsum_cuda(x: torch.Tensor) -> torch.Tensor:
    """K2a on a contiguous [N, lanes] float32 CUDA tensor."""
    global LAUNCHES
    _check_lanes(x)
    _check_kernel_input(x)
    out = torch.empty_like(x)
    if x.numel():
        _launch(x[None], out[None])
        LAUNCHES += 1
    return out


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 of [N, lanes] (lanes | 128)."""
    _check_lanes(x)
    if x.device.type == "cpu":
        return cumsum_plain(x)
    if x.is_cuda:
        return cumsum_cuda(x.contiguous())
    raise ValueError(f"no prefix-scan implementation on {x.device}")


def cumsum_batched_plain(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum along axis 1, accumulated in float32, in x's dtype."""
    return torch.cumsum(x.to(torch.float32), dim=1).to(x.dtype)


def cumsum_batched_cuda(x: torch.Tensor) -> torch.Tensor:
    """K2b on a contiguous [B, N, lanes] float32 CUDA tensor."""
    global BATCHED_LAUNCHES
    _check_lanes(x, ndim=3)
    _check_kernel_input(x)
    out = torch.empty_like(x)
    if x.numel():
        _launch(x, out)
        BATCHED_LAUNCHES += 1
    return out


def cumsum_batched(x: torch.Tensor) -> torch.Tensor:
    """Independent inclusive prefix sums along axis 1 of [B, N, lanes] (lanes | 128)."""
    _check_lanes(x, ndim=3)
    if x.device.type == "cpu":
        return cumsum_batched_plain(x)
    if x.is_cuda:
        return cumsum_batched_cuda(x.contiguous())
    raise ValueError(f"no prefix-scan implementation on {x.device}")
