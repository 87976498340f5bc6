"""The osplit hash grid over all levels: CUDA kernels K4, K3a and K3b and plain twins.

K4 (`oct_split_encode_cuda`) is the osplit forward, `ops/hashgrid.py`'s
`encode_oct_split` in one launch: every level of every point read from the
canonical f32 table [L, T, F], each corner value rounded to bf16 as the
packed tables held it, blended in f32 and written in the compute dtype.
With the table gradient it also writes the level-offset int32 row keys
[L, P] and the weights [P, L, 8] that the backward reads; with the points'
gradient the bf16 corner values [P, L, 8F].

`OctSplitEncode.backward` (`ops/hashgrid.py`) sorts those keys of every
level at once, then runs

- K3a (`sorted_products`): the products of the corner weights and the
  cotangent, rounded to bf16, in sorted order, as [L, P, 8F] float32;
- K2b (`prefix_scan.cumsum_batched`): each level's prefix sums;
- K3b (`fold_segments`): each canonical row's gradient [L, T, F], the
  differences of the prefix sums at its eight physical rows' segment ends.

The kernels live in `csrc/hashgrid_grad.cu` (see the note there). None
replaces a TPU kernel: they take the place of the per-level PyTorch ops the
reference runs through XLA. The plain versions repeat their arithmetic:
K4's is `ops/hashgrid.py:_oct_split_forward_plain` (`encode_oct_split`:
packed bf16 tables, a gather a level, the blend), which dispatches between
the two and hands K4 each level's layout by value; `sorted_products_plain`
in PyTorch ops, `fold_segments_plain` as `ops/hashgrid.py`'s
`_sums_at_ends` and `_fold` level by level, which the port's other sorted
gradients use too.

`sorted_products` and `fold_segments` use the plain version only for a
tensor on the CPU; for a CUDA tensor they launch the kernel or raise
(`cuda_build.use_kernel`). `cuda_build.launches()` counts the launches of
K4, K3a and K3b, and a recording (`cuda_build.recording`) collects their
launch keys: K4's (P, resolutions, log2 T, F, dtype, keys, rows), K3a's
g_lf shape (P, L, F) and K3b's (P, T, F, corner offsets, level rows).
"""

from __future__ import annotations

from typing import Sequence

import torch

from outdoor_nerf_depth_torch.ops import cuda_build
from outdoor_nerf_depth_torch.ops.cuda_build import I32, I64, PTR

SOURCE = "hashgrid_grad"
CORNERS = 8
MAX_LEVELS = 64  # kMaxLevels in the source: the LevelPlan kernel argument's size
FEATURES = (1, 2, 4, 8, 16)  # 8F lanes must divide the scan's 128
K4 = cuda_build.Kernel("K4", SOURCE, "osplit_encode", PTR, PTR, PTR, I32, PTR, PTR, PTR, I64,
                       I64, I64, I32, PTR, PTR, PTR)
K3A = cuda_build.Kernel("K3a", SOURCE, "osplit_grad_products_f32", PTR, PTR, PTR, PTR, I64, I64,
                        I32)
K3B = cuda_build.Kernel("K3b", SOURCE, "osplit_grad_fold_f32", PTR, PTR, PTR, I64, I64, I64, I32,
                        PTR, PTR)


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


def _check_cuda(x: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str):
    if not (x.is_cuda and x.dtype == dtype and x.is_contiguous() and tuple(x.shape) == shape):
        raise ValueError(f"{name}: kernel takes a contiguous {dtype} CUDA tensor of shape "
                         f"{shape}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_sizes(n_levels: int, n_feats: int):
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"kernel takes 1 to {MAX_LEVELS} levels, got {n_levels}")
    if n_feats not in FEATURES:
        raise ValueError(f"kernel takes {FEATURES} features a level, got {n_feats}")


def oct_split_encode_cuda(x: torch.Tensor, table: torch.Tensor, resolutions, strides,
                          pair_offsets, dtype: torch.dtype = torch.float32, keys: bool = False,
                          rows: bool = False):
    """K4 on CUDA tensors x [P, 3] and table [L, T, F] float32, contiguous,
    the table 16-byte aligned. Per level, passed by value: its resolution,
    its dense stride res + 1 (0 on a hashed level) and the row offsets of
    corners 0, 2, 4 and 6 (corner 2k + 1 is the row after 2k's), L x 4 in
    `pair_offsets`. Returns (features [P, L F] in `dtype`, keys [L, P]
    int32 and w_all [P, L, 8] float32 if `keys`, rows [P, L, 8F] bfloat16
    if `rows`; None for what is not asked for)."""
    n_levels, table_size, n_feats = table.shape
    _check_sizes(n_levels, n_feats)
    n_points = x.shape[0]
    _check_cuda(x, torch.float32, (n_points, 3), "x")
    _check_cuda(table, torch.float32, (n_levels, table_size, n_feats), "table")
    if x.device != table.device or table.data_ptr() % 16:
        raise ValueError(f"kernel takes x and a 16-byte aligned table on one device, got "
                         f"{x.device} and {table.device} at {table.data_ptr():#x}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel writes float32 or bfloat16 features, not {dtype}")
    if not len(resolutions) == len(strides) == n_levels or len(pair_offsets) != 4 * n_levels:
        raise ValueError(f"{n_levels} levels, {len(resolutions)} resolutions, {len(strides)} "
                         f"strides, {len(pair_offsets)} pair offsets")
    if keys and n_levels * table_size > torch.iinfo(torch.int32).max:
        raise ValueError(f"{n_levels} levels of {table_size} rows overflow the int32 sort keys")
    plan_res = (I32 * n_levels)(*(int(r) for r in resolutions))
    plan_strides = (I32 * n_levels)(*(int(s) for s in strides))
    plan_pairs = (I32 * len(pair_offsets))(*(int(o) for o in pair_offsets))
    dev = table.device
    out = torch.empty((n_points, n_levels * n_feats), dtype=dtype, device=dev)
    level_keys = torch.empty((n_levels, n_points), dtype=torch.int32, device=dev) if keys else None
    w_all = torch.empty((n_points, n_levels, CORNERS), device=dev) if keys else None
    gathered = (torch.empty((n_points, n_levels, CORNERS * n_feats), dtype=torch.bfloat16,
                            device=dev) if rows else None)
    if n_points:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        K4(dev, x.data_ptr(), table.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
           ptr(level_keys), ptr(w_all), ptr(gathered), n_levels, n_points, table_size, n_feats,
           plan_res, plan_strides, plan_pairs,
           key=lambda: (n_points, tuple(int(r) for r in resolutions), table_size.bit_length() - 1,
                        n_feats, str(dtype).split(".")[-1], bool(keys), bool(rows)))
    return out, level_keys, w_all, gathered


def sorted_products_cuda(order: torch.Tensor, w_all: torch.Tensor,
                         g_lf: torch.Tensor) -> torch.Tensor:
    """K3a on CUDA tensors: order [L P] int64, w_all [P, L, 8] and g_lf
    [P, L, F] float32, all contiguous."""
    n_points, n_levels, n_feats = g_lf.shape
    _check_sizes(n_levels, n_feats)
    _check_cuda(order, torch.int64, (n_levels * n_points,), "order")
    _check_cuda(w_all, torch.float32, (n_points, n_levels, CORNERS), "w_all")
    _check_cuda(g_lf, torch.float32, (n_points, n_levels, n_feats), "g_lf")
    vals = torch.empty((n_levels, n_points, CORNERS * n_feats), device=g_lf.device)
    if n_points:
        K3A(g_lf.device, order.data_ptr(), w_all.data_ptr(), g_lf.data_ptr(), vals.data_ptr(),
            n_levels, n_points, n_feats, key=lambda: tuple(g_lf.shape))
    return vals


def sorted_products(order: torch.Tensor, w_all: torch.Tensor, g_lf: torch.Tensor) -> torch.Tensor:
    """[L, P, 8F] bf16-rounded products in sorted order (see the plain version)."""
    if cuda_build.use_kernel(g_lf, "osplit gradient"):
        return sorted_products_cuda(order.contiguous(), w_all.contiguous(), g_lf.contiguous())
    return sorted_products_plain(order, w_all, g_lf)


def fold_segments_cuda(csum: torch.Tensor, ends: torch.Tensor, offsets: Sequence,
                       level_rows: Sequence[int], table_size: int) -> torch.Tensor:
    """K3b on CUDA tensors: csum [L, P, 8F] float32 and ends [L T] int32,
    contiguous; offsets and level_rows as Python integers, passed by value."""
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
    plan_offsets = (I32 * len(flat))(*flat)
    plan_rows = (I32 * n_levels)(*(int(r) for r in level_rows))
    K3B(csum.device, csum.data_ptr(), ends.data_ptr(), out.data_ptr(), n_levels, n_points,
        table_size, n_feats, plan_offsets, plan_rows,
        key=lambda: (n_points, table_size, n_feats,
                     tuple(tuple(int(o) for o in level) for level in offsets),
                     tuple(int(r) for r in level_rows)))
    return out


def fold_segments(csum: torch.Tensor, ends: torch.Tensor, offsets: Sequence,
                  level_rows: Sequence[int], table_size: int) -> torch.Tensor:
    """[L, T, F] canonical table gradient (see the plain version)."""
    if cuda_build.use_kernel(csum, "osplit gradient"):
        return fold_segments_cuda(csum.contiguous(), ends.contiguous(), offsets, level_rows,
                                  table_size)
    return fold_segments_plain(csum, ends, offsets, level_rows, table_size)
