"""Multiresolution hash-grid encoding, "osplit" layout (the Instant-NGP field).

Port of the osplit path of the reference package's `ops/hashgrid.py`. The
hash is fully linear, h(x, y, z) = (x P1 + y P2 + z) mod T, on levels whose
dense grid outgrows the table T; coarser levels index their (res+1)^3 grid
injectively. Under a linear hash the eight corners of a cell sit at fixed
row offsets from the cell's base row, so each level keeps a bf16 "physical"
table whose row i packs the canonical rows i + offset_c of all eight
corners (8F lanes), trimmed to (res+1)^3 rows on dense levels. The forward
is one row gather per (point, level) and a trilinear blend in f32.

The table gradient is the reference's scatter-free sorted-segment sum, per
level: each product w*g is rounded to bf16, the [points, 8F] stream is
sorted by physical row and prefix-summed in f32 (CUDA kernel K2a on the
GPU, `ops/prefix_scan.py`), and each row's sum is the difference of the
prefix sums at its segment's ends; eight rolls fold the physical-row sums
back onto the canonical table. `grad_mode` "auto" and "sorted" both take
this path on every device. The encoding computes in f32 and returns its
features in the module's `compute_dtype`, as the reference does; a bf16
cotangent is cast back to f32 before the table gradient. The layouts
"oct", "quad" and "corner", and `pack_rows`, are not ported and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from outdoor_nerf_depth_torch.ops import mathx, prefix_scan

# Large primes of the Instant-NGP spatial hash (x uses stride 1).
_PRIMES = (1, 2_654_435_761, 805_459_861)
LAYOUTS = ("osplit", "oct", "quad", "corner")


def growth_factor(n_levels: int, n_min: int, n_max: int) -> float:
    if n_levels <= 1:
        return 1.0
    return float(np.exp((np.log(n_max) - np.log(n_min)) / (n_levels - 1)))


def level_resolutions(n_levels: int, n_min: int, n_max: int) -> np.ndarray:
    b = growth_factor(n_levels, n_min, n_max)
    return np.floor(n_min * b ** np.arange(n_levels)).astype(np.int32)


def _is_dense(resolution: int, table_size: int) -> bool:
    return (resolution + 1) ** 3 <= table_size


def _quad_base_index(cell: torch.Tensor, resolution: int, table_size: int) -> torch.Tensor:
    """Row of the (x0, y0, z0) corner of int64 cells [..., 3].

    Dense levels use the x-major layout x (s^2) + y s + z with s = res + 1;
    hashed levels (x P1 + y P2 + z) mod T. The reference multiplies uint32
    values with wraparound and masks with T - 1; T is a power of two that
    divides 2^32, so the low bits of the exact int64 sum are the same.
    """
    if _is_dense(resolution, table_size):
        s = resolution + 1
        return cell[..., 0] * (s * s) + cell[..., 1] * s + cell[..., 2]
    h = cell[..., 0] * _PRIMES[1] + cell[..., 1] * _PRIMES[2] + cell[..., 2]
    return h & (table_size - 1)


def _oct_offsets(resolution: int, table_size: int):
    """Row offsets of the eight cell corners, lane = 4 cx + 2 cy + cz."""
    if _is_dense(resolution, table_size):
        s = resolution + 1
        sx, sy = s * s, s
    else:
        sx = int(_PRIMES[1] % table_size)
        sy = int(_PRIMES[2] % table_size)
    return [cx * sx + cy * sy + cz for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)]


def _oct_level_rows(resolutions: Sequence[int], table_size: int):
    """Rows of each level's trimmed physical table: (res+1)^3 if dense, else T."""
    return [(int(r) + 1) ** 3 if _is_dense(int(r), table_size) else table_size
            for r in resolutions]


def build_oct_tables_split(table: torch.Tensor, resolutions, table_size: int,
                           dtype=torch.bfloat16):
    """Per-level physical tables [rows_l, 8F]: row i, lane c holds
    canonical row (i + offset_c) mod T of the level, cast to `dtype`."""
    out = []
    level_rows = _oct_level_rows(resolutions, table_size)
    for level, res in enumerate(resolutions):
        offs = torch.tensor(_oct_offsets(int(res), table_size), device=table.device)
        rows = (torch.arange(level_rows[level], device=table.device)[:, None] + offs) % table_size
        packed = table[level][rows]  # [rows_l, 8, F]
        out.append(packed.reshape(level_rows[level], -1).to(dtype))
    return tuple(out)


def _corner_bits(device) -> torch.Tensor:
    """[8, 3] bool: bit d of corner lane c = 4 cx + 2 cy + cz."""
    return torch.tensor([[(c >> (2 - d)) & 1 for d in range(3)] for c in range(8)],
                        dtype=torch.bool, device=device)


def _corner_factors(frac: torch.Tensor) -> torch.Tensor:
    """[..., 8, 3]: per corner and axis, frac if the corner's bit is set, else 1 - frac."""
    return torch.where(_corner_bits(frac.device), frac[..., None, :], 1.0 - frac[..., None, :])


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights [..., 8] of the cell corners in lane order."""
    fd = _corner_factors(frac)
    return fd[..., 0] * fd[..., 1] * fd[..., 2]


def _level_cells(x: torch.Tensor, resolution: int):
    """(cell int64 [..., 3], frac [..., 3]) of clipped unit-cube points."""
    pos = x * resolution
    cell = torch.clamp(torch.floor(pos).to(torch.int64), 0, resolution - 1)
    return cell, pos - cell


def _oct_local_indices_weights(x: torch.Tensor, resolutions, table_size: int):
    """(idx per level [...] into that level's table, w [..., L, 8])."""
    x = torch.clamp(x, 0.0, 1.0)
    idx_levels, w_levels = [], []
    for res in resolutions:
        cell, frac = _level_cells(x, int(res))
        idx_levels.append(_quad_base_index(cell, int(res), table_size))
        w_levels.append(_corner_weights(frac))
    return idx_levels, torch.stack(w_levels, dim=-2)


def _blend(rows, w_all: torch.Tensor, n_feats: int) -> torch.Tensor:
    """Trilinear blend in f32 of gathered bf16 rows -> [..., L*F]."""
    outs = []
    for level, r in enumerate(rows):
        feats = r.to(torch.float32).reshape(r.shape[:-1] + (8, n_feats))
        outs.append(torch.sum(w_all[..., level, :, None] * feats, dim=-2))
    return torch.cat(outs, dim=-1)


def encode_oct_split(x, table, resolutions, table_size: int, phys=None):
    """Hash-encode unit-cube points [..., 3] -> [..., L*F] through the
    per-level bf16 physical tables (`phys` from `build_oct_tables_split`, or
    built here). Plain autograd would differentiate it with a scatter-add;
    training uses `OctSplitEncode`."""
    idx_levels, w_all = _oct_local_indices_weights(x, resolutions, table_size)
    if phys is None:
        phys = build_oct_tables_split(table, resolutions, table_size)
    rows = [phys[level][idx] for level, idx in enumerate(idx_levels)]
    return _blend(rows, w_all, table.shape[-1])


def _oct_split_row_sums(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Sums of `vals` [m, lanes] per row id `idx` [m] in [0, n_rows), scatter-free.

    Each value is rounded to bf16 first, as in the reference. The values are
    sorted by row and prefix-summed in f32 (K2a on the GPU); with
    b_r = #(idx <= r), row r's sum is csum[b_r - 1] - csum[b_{r-1} - 1]. The
    reference finds b_r with two sentinel sorts; `searchsorted` on the
    sorted ids gives the same integers.
    """
    lanes = vals.shape[-1]
    vals = vals.to(torch.bfloat16)
    sorted_idx, order = torch.sort(idx)
    csum = prefix_scan.cumsum(vals[order].to(torch.float32))
    rows = torch.arange(n_rows, device=idx.device, dtype=sorted_idx.dtype)
    b = torch.searchsorted(sorted_idx, rows, right=True)
    ge = torch.where((b > 0)[:, None], csum[torch.clamp(b - 1, min=0)], 0.0)
    return ge - torch.cat([ge.new_zeros((1, lanes)), ge[:-1]], dim=0)


def _oct_split_row_sums_merged(idx: torch.Tensor, vals: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """The same row sums by the reference's "merged" pipeline.

    One sort over m + n_rows keys interleaves data keys 2 idx with one
    sentinel key 2 r + 1 per row; the bf16-rounded values gathered in that
    order (sentinels carry 0) are prefix-summed in f32 (K2a on the GPU), so
    the prefix at row r's sentinel is the total of rows <= r. A stable
    partition finds the sentinels, and row sums are adjacent differences.
    The reference selects it with an environment switch; here only the
    osplit backward probe calls it, and training keeps `_oct_split_row_sums`.
    """
    m, lanes = vals.shape
    vals = vals.to(torch.bfloat16)
    rows = torch.arange(n_rows, device=idx.device, dtype=idx.dtype)
    sorted_keys, pos = torch.sort(torch.cat([idx * 2, rows * 2 + 1]), stable=True)
    gathered = vals[torch.clamp(pos, max=m - 1)].to(torch.float32)
    csum = prefix_scan.cumsum(torch.where((pos < m)[:, None], gathered, 0.0))
    _, order = torch.sort((sorted_keys & 1) ^ 1, stable=True)
    at_sentinel = csum[order[:n_rows]]
    return at_sentinel - torch.cat([at_sentinel.new_zeros((1, lanes)), at_sentinel[:-1]], dim=0)


def _trilinear_dx(x: torch.Tensor, resolutions, s: torch.Tensor) -> torch.Tensor:
    """dL/dx from per-corner sums s [..., L, 8]: dw/dx_d = res sign_d prod_{d' != d} f_d'."""
    xc = torch.clamp(x, 0.0, 1.0)
    sign = torch.where(_corner_bits(x.device), 1.0, -1.0)  # [8, 3]
    dx = torch.zeros_like(x)
    for level, res in enumerate(resolutions):
        _, frac = _level_cells(xc, int(res))
        fd = _corner_factors(frac)  # [..., 8, 3]
        f0, f1, f2 = fd[..., 0], fd[..., 1], fd[..., 2]
        others = torch.stack([f1 * f2, f0 * f2, f0 * f1], dim=-1)
        dw_dx = float(res) * sign * others  # [..., 8, 3]
        dx = dx + torch.sum(s[..., level, :, None] * dw_dx, dim=-2)
    in_range = (x > 0.0) & (x < 1.0)
    return torch.where(in_range, dx, 0.0)


class OctSplitEncode(torch.autograd.Function):
    """encode_oct_split with the sorted-segment table gradient (K2a inside)."""

    @staticmethod
    def forward(ctx, x, table, resolutions, table_size):
        idx_levels, w_all = _oct_local_indices_weights(x, resolutions, table_size)
        phys = build_oct_tables_split(table, resolutions, table_size)
        rows = [phys[level][idx] for level, idx in enumerate(idx_levels)]  # bf16 residuals
        ctx.save_for_backward(x, w_all, *idx_levels, *rows)
        ctx.resolutions, ctx.table_size = tuple(int(r) for r in resolutions), table_size
        ctx.table_shape = table.shape
        return _blend(rows, w_all, table.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w_all, *saved = ctx.saved_tensors
        resolutions, table_size = ctx.resolutions, ctx.table_size
        n_levels, _, n_feats = ctx.table_shape
        idx_levels, rows = saved[:n_levels], saved[n_levels:]
        g_lf = g.to(torch.float32).reshape(g.shape[:-1] + (n_levels, n_feats))
        level_rows = _oct_level_rows(resolutions, table_size)
        canon, s_levels = [], []
        for level, res in enumerate(resolutions):
            g_l = g_lf[..., level, :]
            vals = (w_all[..., level, :, None] * g_l[..., None, :]).reshape(-1, 8 * n_feats)
            seg = _oct_split_row_sums(idx_levels[level].reshape(-1), vals, level_rows[level])
            p = F.pad(seg, (0, 0, 0, table_size - level_rows[level]))
            acc = p[:, :n_feats]
            for lane, o in enumerate(_oct_offsets(res, table_size)[1:], start=1):
                acc = acc + torch.roll(p[:, lane * n_feats:(lane + 1) * n_feats], o, dims=0)
            canon.append(acc)
            if ctx.needs_input_grad[0]:
                feats = rows[level].to(torch.float32).reshape(rows[level].shape[:-1] + (8, n_feats))
                s_levels.append(torch.sum(g_l[..., None, :] * feats, dim=-1))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _trilinear_dx(x, resolutions, torch.stack(s_levels, dim=-2))
        return dx, torch.stack(canon), None, None


class HashGridEncoding(nn.Module):
    """Learnable multiresolution hash encoding; the table is `table` [L, T, F]."""

    def __init__(
        self,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_resolution: int = 16,
        max_resolution: int = 2048,
        init_scale: float = 1e-4,
        pack_rows: int = 0,
        grad_mode: str = "auto",
        layout: str = "osplit",
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if layout not in LAYOUTS:
            raise ValueError(f"unknown hash-grid layout {layout!r}; expected one of {LAYOUTS}")
        if layout == "osplit" and pack_rows > 1:
            raise ValueError("layout='osplit' is incompatible with pack_rows>1")
        if layout != "osplit":
            raise NotImplementedError(f"hash-grid layout {layout!r} is not ported yet")
        if grad_mode not in ("auto", "sorted"):
            raise NotImplementedError(f"grad_mode={grad_mode!r} is not ported yet")
        self.compute_dtype = mathx.as_dtype(compute_dtype)
        self.table_size = 2**log2_table_size
        self.resolutions = tuple(
            int(r) for r in level_resolutions(n_levels, base_resolution, max_resolution)
        )
        table = torch.empty(n_levels, self.table_size, n_features)
        self.table = nn.Parameter(table.uniform_(-init_scale, init_scale, generator=generator))

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * self.table.shape[2]

    def prepare(self):
        """The per-level physical tables, for repeated encodes of frozen weights."""
        with torch.no_grad():
            return build_oct_tables_split(self.table, self.resolutions, self.table_size)

    def forward(self, x, prepared=None):
        if prepared is not None:
            out = encode_oct_split(x, self.table, self.resolutions, self.table_size, prepared)
        else:
            out = OctSplitEncode.apply(x, self.table, self.resolutions, self.table_size)
        return out.to(self.compute_dtype)


def spherical_harmonics(d: torch.Tensor, out_dim: int = 16) -> torch.Tensor:
    """Real spherical harmonics through degree 3 of unit directions [..., 3]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [
        0.28209479177387814 * torch.ones_like(x),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ]
    return torch.stack(comps[:out_dim], dim=-1)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.exp(torch.clamp(x, -bound, bound))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -ctx.bound, ctx.bound)), None


def truncated_exp(x: torch.Tensor, bound: float = 15.0) -> torch.Tensor:
    """exp(clip(x)) whose gradient is g exp(clip(x)) everywhere, also
    outside the clip (autograd of exp(clamp(x)) would zero it there)."""
    return _TruncExp.apply(x, bound)
