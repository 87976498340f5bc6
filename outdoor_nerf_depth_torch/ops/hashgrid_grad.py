"""The osplit hash-table gradient over all levels: CUDA kernels K3a and K3b and plain twins.

`OctSplitEncode.backward` (`ops/hashgrid.py`) sorts the level-offset row
ids of every level at once, then runs

- K3a (`sorted_products`): the products of the corner weights and the
  cotangent, rounded to bf16, in sorted order, as [L, P, 8F] float32;
- K2b (`prefix_scan.cumsum_batched`): each level's prefix sums;
- K3b (`fold_segments`): each canonical row's gradient [L, T, F], the
  differences of the prefix sums at its eight physical rows' segment ends.

Both kernels live in `csrc/hashgrid_grad.cu` (see the note there). Neither
replaces a TPU kernel: they take the place of the per-level PyTorch ops the
reference runs through XLA. The plain versions repeat their arithmetic:
`sorted_products_plain` in PyTorch ops, `fold_segments_plain` as
`ops/hashgrid.py`'s `_sums_at_ends` and `_fold` level by level, which the
port's other sorted gradients use too.

`sorted_products` and `fold_segments` use the plain version only for a
tensor on the CPU; for a CUDA tensor they launch the kernel or raise.
`PRODUCT_LAUNCHES` (K3a) and `FOLD_LAUNCHES` (K3b) count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from outdoor_nerf_depth_torch.ops import cuda_build

SOURCE = "hashgrid_grad"
CORNERS = 8
MAX_LEVELS = 64  # kMaxLevels in the source: the LevelPlan kernel argument's size
FEATURES = (1, 2, 4, 8, 16)  # 8F lanes must divide the scan's 128

PRODUCT_LAUNCHES = 0
FOLD_LAUNCHES = 0


def reset_launch_counts():
    global PRODUCT_LAUNCHES, FOLD_LAUNCHES
    PRODUCT_LAUNCHES = FOLD_LAUNCHES = 0


# ---- plain versions --------------------------------------------------------


def sorted_products_plain(order: torch.Tensor, w_all: torch.Tensor,
                          g_lf: torch.Tensor) -> torch.Tensor:
    """[L, P, 8F]: row i of level l holds f32(bf16(w[p, l, c] g[p, l, f]))
    at lane c F + f, for p = order[l P + i] - l P, the point that the sort
    of the level-offset row ids put at position i of the level's block."""
    n_points, n_levels = w_all.shape[:2]
    level = torch.arange(n_levels, device=order.device)[:, None]
    p = order.reshape(n_levels, n_points) - level * n_points
    prod = w_all[p, level, :, None] * g_lf[p, level, None, :]  # [L, P, 8, F]
    return prod.reshape(n_levels, n_points, -1).to(torch.bfloat16).to(torch.float32)


def fold_segments_plain(csum: torch.Tensor, ends: torch.Tensor, offsets: Sequence,
                        level_rows: Sequence[int], table_size: int) -> torch.Tensor:
    """[L, T, F]: per level, the row sums of its trimmed rows from the
    prefix sums csum [L, P, 8F] at the flat segment ends `ends` [L T] (the
    count of sorted entries, all levels', at or below each level-offset
    row), folded back onto the canonical table by the corner offsets:
    `ops/hashgrid.py`'s `_sums_at_ends` and `_fold`, a level at a time."""
    from outdoor_nerf_depth_torch.ops import hashgrid  # which imports this module

    n_levels, n_points, lanes = csum.shape
    n_feats = lanes // CORNERS
    ends = ends.reshape(n_levels, table_size).to(torch.int64)
    return torch.stack([
        hashgrid._fold(hashgrid._sums_at_ends(csum[level], ends[level, :rows] - level * n_points),
                       offsets[level], table_size, n_feats)
        for level, rows in enumerate(level_rows)])


# ---- kernels ---------------------------------------------------------------


def _lib():
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.osplit_grad_products_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
        lib.osplit_grad_products_f32.restype = i32
        lib.osplit_grad_fold_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64, i32, ptr, ptr, ptr]
        lib.osplit_grad_fold_f32.restype = i32
        lib._argtypes_set = True
    return lib


def _check_cuda(x: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str):
    if not (x.is_cuda and x.dtype == dtype and x.is_contiguous() and tuple(x.shape) == shape):
        raise ValueError(f"{name}: kernel takes a contiguous {dtype} CUDA tensor of shape "
                         f"{shape}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_sizes(n_levels: int, n_feats: int):
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"kernel takes 1 to {MAX_LEVELS} levels, got {n_levels}")
    if n_feats not in FEATURES:
        raise ValueError(f"kernel takes {FEATURES} features a level, got {n_feats}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def sorted_products_cuda(order: torch.Tensor, w_all: torch.Tensor,
                         g_lf: torch.Tensor) -> torch.Tensor:
    """K3a on CUDA tensors: order [L P] int64, w_all [P, L, 8] and g_lf
    [P, L, F] float32, all contiguous."""
    global PRODUCT_LAUNCHES
    n_points, n_levels, n_feats = g_lf.shape
    _check_sizes(n_levels, n_feats)
    _check_cuda(order, torch.int64, (n_levels * n_points,), "order")
    _check_cuda(w_all, torch.float32, (n_points, n_levels, CORNERS), "w_all")
    _check_cuda(g_lf, torch.float32, (n_points, n_levels, n_feats), "g_lf")
    vals = torch.empty((n_levels, n_points, CORNERS * n_feats), device=g_lf.device)
    if n_points:
        with torch.cuda.device(g_lf.device):
            code = _lib().osplit_grad_products_f32(
                order.data_ptr(), w_all.data_ptr(), g_lf.data_ptr(), vals.data_ptr(), n_levels,
                n_points, n_feats, _stream(g_lf))
        if code != 0:
            raise RuntimeError(f"osplit_grad_products launch failed: cudaError {code}")
        PRODUCT_LAUNCHES += 1
    return vals


def sorted_products(order: torch.Tensor, w_all: torch.Tensor, g_lf: torch.Tensor) -> torch.Tensor:
    """[L, P, 8F] bf16-rounded products in sorted order (see the plain version)."""
    if g_lf.device.type == "cpu":
        return sorted_products_plain(order, w_all, g_lf)
    if g_lf.is_cuda:
        return sorted_products_cuda(order.contiguous(), w_all.contiguous(), g_lf.contiguous())
    raise ValueError(f"no osplit gradient implementation on {g_lf.device}")


def fold_segments_cuda(csum: torch.Tensor, ends: torch.Tensor, offsets: Sequence,
                       level_rows: Sequence[int], table_size: int) -> torch.Tensor:
    """K3b on CUDA tensors: csum [L, P, 8F] float32 and ends [L T] int32,
    contiguous; offsets and level_rows as Python integers, passed by value."""
    global FOLD_LAUNCHES
    n_levels, n_points, lanes = csum.shape
    n_feats = lanes // CORNERS
    _check_sizes(n_levels, n_feats)
    _check_cuda(csum, torch.float32, (n_levels, n_points, CORNERS * n_feats), "csum")
    _check_cuda(ends, torch.int32, (n_levels * table_size,), "ends")
    if len(offsets) != n_levels or len(level_rows) != n_levels:
        raise ValueError(f"{n_levels} levels, {len(offsets)} offset lists, "
                         f"{len(level_rows)} row counts")
    flat = [int(o) for level in offsets for o in level]
    if len(flat) != CORNERS * n_levels:
        raise ValueError(f"expected {CORNERS} corner offsets a level, got {offsets}")
    out = torch.empty((n_levels, table_size, n_feats), device=csum.device)
    plan_offsets = (ctypes.c_int * len(flat))(*flat)
    plan_rows = (ctypes.c_int * n_levels)(*(int(r) for r in level_rows))
    with torch.cuda.device(csum.device):
        code = _lib().osplit_grad_fold_f32(
            csum.data_ptr(), ends.data_ptr(), out.data_ptr(), n_levels, n_points, table_size,
            n_feats, plan_offsets, plan_rows, _stream(csum))
    if code != 0:
        raise RuntimeError(f"osplit_grad_fold launch failed: cudaError {code}")
    FOLD_LAUNCHES += 1
    return out


def fold_segments(csum: torch.Tensor, ends: torch.Tensor, offsets: Sequence,
                  level_rows: Sequence[int], table_size: int) -> torch.Tensor:
    """[L, T, F] canonical table gradient (see the plain version)."""
    if csum.device.type == "cpu":
        return fold_segments_plain(csum, ends, offsets, level_rows, table_size)
    if csum.is_cuda:
        return fold_segments_cuda(csum.contiguous(), ends.contiguous(), offsets, level_rows,
                                  table_size)
    raise ValueError(f"no osplit gradient implementation on {csum.device}")
