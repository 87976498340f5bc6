"""Multiresolution hash-grid encoding (the Instant-NGP field), every layout.

Port of the reference package's `ops/hashgrid.py`. Four table layouts:

- "corner": the classic spatial hash of tiny-cuda-nn, (x P0) ^ (y P1) ^
  (z P2) mod T on levels whose dense grid outgrows the table T, z-major
  injective indexing x + y s + z s^2 (s = res + 1) on coarser levels; eight
  row gathers per (point, level). `pack_rows` P > 1 views the table as
  [L T / P, P F], gathers those wide rows and selects the F lanes.
- "osplit" (default), "oct", "quad": one fully linear hash,
  (x P1 + y P2 + z) mod T, x-major dense indexing x s^2 + y s + z. Under a
  linear hash the eight corners of a cell sit at fixed row offsets from its
  base row, so a "physical" table whose row i packs the canonical rows
  i + offset_c serves a cell in one gather ("oct": eight corners, 8F
  lanes, one f32 table trimmed to (res+1)^3 rows on dense levels; "osplit":
  the same, one bf16 table per level) or two ("quad": four corners y/z,
  4F lanes, [L, T, 4F]). The three share the hash, so their trained tables
  are interchangeable; corner's are not.

On the card the osplit forward builds no physical table: CUDA kernel K4
(`ops/hashgrid_grad.py`) reads the canonical table and computes every level
of every point in one launch, bit for bit what `encode_oct_split` computes
from the packed bf16 tables, which stay the plain twin on the CPU.

The hashes are computed in int64 and masked with T - 1. The reference
multiplies uint32 values with wraparound; T is a power of two dividing
2^32, so the low bits of the exact int64 products (and of their XOR) are
the same.

`grad_mode` "sorted" and "auto" take the reference's scatter-free
sorted-segment table gradient on every device; "scatter" differentiates the
gathers with autograd (an accumulating index_put), as does `pack_rows`,
except osplit's on the card, which K4 encodes and which refuses it.
The sorted gradients:

- osplit: each product w*g rounded to bf16, sorted by physical row within
  its level and prefix-summed in f32 level by level; each row's sum is the
  difference of the prefix sums at its segment's ends. This is the
  reference's default pipeline, computed in one pass over all levels: one
  sort of the level-offset row ids, the sorted products by CUDA kernel K3a
  (`ops/hashgrid_grad.py`), one launch of the batched scan K2b
  (`ops/prefix_scan.py`), the segment ends by one `searchsorted`, and the
  differences folded back onto the canonical table by K3b. The reference's
  environment switches (an f32 gather, the one-sort "merged" pipeline) are
  not read here. The per-level pipeline the one pass replaced
  (`_oct_split_table_grad_per_level`: `_oct_split_row_sums`, K2a on the
  GPU, and `_fold` a level) and `_oct_split_row_sums_merged` serve the
  osplit backward probe and the tests.
- oct: the same in one pass over all levels, [points x L, 8F] in f32 (one
  K2a launch).
- corner and quad: the reference's sentinel pipeline over the canonical
  (corner) or quad rows, scanned with torch.cumsum as the reference scans
  with jnp.cumsum.

Rolls fold the physical-row sums back onto the canonical table (`_fold`;
K3b folds the osplit one pass's). The position gradient is the analytic
derivative of the trilinear weights. The encoding computes in f32 and
returns its features in the module's `compute_dtype`, as the reference
does; a bf16 cotangent is cast back to f32 before the table gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from outdoor_nerf_depth_torch.ops import cuda_build, hashgrid_grad, mathx, prefix_scan
from outdoor_nerf_depth_torch.utils import tracing

# Large primes of the Instant-NGP spatial hash (x uses stride 1).
_PRIMES = (1, 2_654_435_761, 805_459_861)
LAYOUTS = ("osplit", "oct", "quad", "corner")
GRAD_MODES = ("auto", "sorted", "scatter")


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
    """Row of the (x0, y0, z0) corner of int64 cells [..., 3] under the
    linear hash: x (s^2) + y s + z (s = res + 1) on dense levels, else
    (x P1 + y P2 + z) mod T."""
    if _is_dense(resolution, table_size):
        s = resolution + 1
        return cell[..., 0] * (s * s) + cell[..., 1] * s + cell[..., 2]
    h = cell[..., 0] * _PRIMES[1] + cell[..., 1] * _PRIMES[2] + cell[..., 2]
    return h & (table_size - 1)


def _oct_offsets(resolution: int, table_size: int):
    """Row offsets of the eight cell corners under the linear hash, lane =
    4 cx + 2 cy + cz. The first four are the quad layout's lanes {0, 1, Sy,
    Sy + 1}; lane 4 is the offset of the x + 1 corner."""
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


def _packed_rows(level_table: torch.Tensor, offsets, n_rows: int) -> torch.Tensor:
    """[n_rows, len(offsets) F]: row i, lane c holds canonical row
    (i + offsets[c]) mod T of the level (the reference's rolls)."""
    table_size = level_table.shape[0]
    offs = torch.tensor(offsets, device=level_table.device)
    rows = (torch.arange(n_rows, device=level_table.device)[:, None] + offs) % table_size
    return level_table[rows].reshape(n_rows, -1)


def build_oct_tables_split(table: torch.Tensor, resolutions, table_size: int,
                           dtype=torch.bfloat16):
    """Per-level trimmed oct physical tables [rows_l, 8F], cast to `dtype`."""
    level_rows = _oct_level_rows(resolutions, table_size)
    return tuple(_packed_rows(table[level], _oct_offsets(int(res), table_size),
                              level_rows[level]).to(dtype)
                 for level, res in enumerate(resolutions))


def build_oct_table(table: torch.Tensor, resolutions, table_size: int) -> torch.Tensor:
    """The oct layout's one physical table [sum(rows_l), 8F], in the table's dtype."""
    return torch.cat(build_oct_tables_split(table, resolutions, table_size, table.dtype))


def build_quad_table(table: torch.Tensor, resolutions, table_size: int) -> torch.Tensor:
    """The quad layout's physical table [L, T, 4F]: row i packs canonical
    rows i, i + 1, i + Sy, i + Sy + 1 (mod T; dense levels never read the
    wrapped rows)."""
    return torch.stack([_packed_rows(table[level], _oct_offsets(int(res), table_size)[:4],
                                     table_size)
                        for level, res in enumerate(resolutions)])


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


def _blend_levels(feats: torch.Tensor, w_all: torch.Tensor) -> torch.Tensor:
    """sum_c w[..., L, c] feats[..., L, c, F] -> [..., L*F]."""
    out = torch.sum(w_all[..., None] * feats, dim=-2)
    return out.reshape(out.shape[:-2] + (-1,))


# ---- corner layout -------------------------------------------------------


def _hash_corner(coords: torch.Tensor, resolution: int, table_size: int) -> torch.Tensor:
    """Row of int64 grid coords [..., 3]: z-major x + y s + z s^2 (s = res
    + 1) on dense levels, else (x P0) ^ (y P1) ^ (z P2) mod T."""
    if _is_dense(resolution, table_size):
        s = resolution + 1
        return coords[..., 0] + coords[..., 1] * s + coords[..., 2] * (s * s)
    h = (coords[..., 0] * _PRIMES[0]) ^ (coords[..., 1] * _PRIMES[1]) ^ (coords[..., 2] * _PRIMES[2])
    return h & (table_size - 1)


def _corner_indices_weights(x: torch.Tensor, resolutions, table_size: int):
    """(idx [..., L, 8] into the flattened [L*T] table, w [..., L, 8])."""
    x = torch.clamp(x, 0.0, 1.0)
    corners = _corner_bits(x.device).to(torch.int64)
    idx_levels, w_levels = [], []
    for level, res in enumerate(resolutions):
        cell, frac = _level_cells(x, int(res))
        idx = _hash_corner(cell[..., None, :] + corners, int(res), table_size)
        idx_levels.append(idx + level * table_size)
        w_levels.append(_corner_weights(frac))
    return torch.stack(idx_levels, dim=-2), torch.stack(w_levels, dim=-2)


def encode(x, table, resolutions, table_size: int, pack_rows: int = 0):
    """Hash-encode unit-cube points [..., 3] -> [..., L*F] under the corner
    hash. `pack_rows` P > 1 gathers rows of the [L*T/P, P*F] view of the
    table, then selects each corner's F lanes."""
    n_feats = table.shape[-1]
    idx, w_all = _corner_indices_weights(x, resolutions, table_size)
    if pack_rows > 1:
        rows = table.reshape(-1, pack_rows * n_feats)[idx // pack_rows]  # [..., L, 8, P*F]
        lane = (idx % pack_rows)[..., None] * n_feats + torch.arange(n_feats, device=x.device)
        feats = torch.gather(rows, -1, lane)
    else:
        feats = table.reshape(-1, n_feats)[idx]  # [..., L, 8, F]
    return _blend_levels(feats, w_all)


# ---- quad layout ---------------------------------------------------------


def _quad_indices_weights(x: torch.Tensor, resolutions, table_size: int):
    """(idx [..., L, 2]: the rows of the x0 and x1 corners in the flattened
    [L*T] quad table; w [..., L, 8] ordered (cx, quad lane), so w[..., 4 cx
    + q] weighs lane q of gathered row cx, quad lanes (y0, z0), (y0, z1),
    (y1, z0), (y1, z1))."""
    x = torch.clamp(x, 0.0, 1.0)
    idx_levels, w_levels = [], []
    for level, res in enumerate(resolutions):
        res = int(res)
        cell, frac = _level_cells(x, res)
        base = _quad_base_index(cell, res, table_size)
        x1 = base + _oct_offsets(res, table_size)[4]
        if not _is_dense(res, table_size):  # dense rows stay within the block
            x1 = x1 & (table_size - 1)
        idx_levels.append(torch.stack([base, x1], dim=-1) + level * table_size)
        fx, fy, fz = frac.unbind(-1)
        wq = [(1.0 - fy) * (1.0 - fz), (1.0 - fy) * fz, fy * (1.0 - fz), fy * fz]
        w_levels.append(torch.stack([(1.0 - fx) * q for q in wq] + [fx * q for q in wq], dim=-1))
    return torch.stack(idx_levels, dim=-2), torch.stack(w_levels, dim=-2)


def _gather_quad(phys: torch.Tensor, idx: torch.Tensor, n_feats: int) -> torch.Tensor:
    """The two gathered quad rows per (point, level) as [..., L, 8, F]."""
    rows = phys.reshape(-1, 4 * n_feats)[idx]  # [..., L, 2, 4F]
    return rows.reshape(rows.shape[:-2] + (8, n_feats))


def encode_quad(x, table, resolutions, table_size: int, phys=None):
    """Hash-encode through the quad layout (two gathers per point and
    level); `phys` from `build_quad_table`, or built here."""
    idx, w_all = _quad_indices_weights(x, resolutions, table_size)
    if phys is None:
        phys = build_quad_table(table, resolutions, table_size)
    return _blend_levels(_gather_quad(phys, idx, table.shape[-1]), w_all)


def _quad_dx(x: torch.Tensor, resolutions, s: torch.Tensor) -> torch.Tensor:
    """dL/dx from per-corner sums s [..., L, 8] in (cx, quad lane) order:
    w[4 cx + q] = wx[cx] wq[q] with wx = (1 - fx, fx) and wq = ((1-fy)(1-fz),
    (1-fy) fz, fy (1-fz), fy fz)."""
    xc = torch.clamp(x, 0.0, 1.0)
    dx = torch.zeros_like(x)
    for level, res in enumerate(resolutions):
        r = float(res)
        _, frac = _level_cells(xc, int(res))
        fx, fy, fz = frac.unbind(-1)
        sl = s[..., level, :].reshape(s.shape[:-2] + (2, 4))  # [..., cx, q]
        wq = torch.stack([(1 - fy) * (1 - fz), (1 - fy) * fz, fy * (1 - fz), fy * fz], dim=-1)
        wx = torch.stack([1.0 - fx, fx], dim=-1)
        gx = r * torch.sum(wq * (sl[..., 1, :] - sl[..., 0, :]), dim=-1)
        dwq_dfy = torch.stack([-(1 - fz), -fz, (1 - fz), fz], dim=-1)
        dwq_dfz = torch.stack([-(1 - fy), (1 - fy), -fy, fy], dim=-1)
        gy = r * torch.sum(wx[..., :, None] * dwq_dfy[..., None, :] * sl, dim=(-2, -1))
        gz = r * torch.sum(wx[..., :, None] * dwq_dfz[..., None, :] * sl, dim=(-2, -1))
        dx = dx + torch.stack([gx, gy, gz], dim=-1)
    return torch.where((x > 0.0) & (x < 1.0), dx, 0.0)


# ---- oct and osplit layouts ----------------------------------------------


def _oct_local_indices_weights(x: torch.Tensor, resolutions, table_size: int):
    """(idx per level [...] into that level's table, w [..., L, 8])."""
    x = torch.clamp(x, 0.0, 1.0)
    idx_levels, w_levels = [], []
    for res in resolutions:
        cell, frac = _level_cells(x, int(res))
        idx_levels.append(_quad_base_index(cell, int(res), table_size))
        w_levels.append(_corner_weights(frac))
    return idx_levels, torch.stack(w_levels, dim=-2)


def _oct_indices_weights(x: torch.Tensor, resolutions, table_size: int):
    """(idx [..., L] rows of the concatenated trimmed oct table, w [..., L, 8])."""
    idx_levels, w_all = _oct_local_indices_weights(x, resolutions, table_size)
    starts = np.cumsum([0] + _oct_level_rows(resolutions, table_size)[:-1])
    return torch.stack([i + int(s) for i, s in zip(idx_levels, starts)], dim=-1), w_all


def encode_oct(x, table, resolutions, table_size: int, phys=None):
    """Hash-encode through the oct layout (one gather per point and level
    from one f32 table); `phys` from `build_oct_table`, or built here."""
    idx, w_all = _oct_indices_weights(x, resolutions, table_size)
    if phys is None:
        phys = build_oct_table(table, resolutions, table_size)
    rows = phys[idx]  # [..., L, 8F]
    return _blend_levels(rows.reshape(rows.shape[:-1] + (8, table.shape[-1])), w_all)


def _level_feats(rows: torch.Tensor, n_feats: int) -> torch.Tensor:
    """Gathered bf16 rows [..., L, 8F] -> f32 corner features [..., L, 8, F]."""
    return rows.to(torch.float32).reshape(rows.shape[:-1] + (8, n_feats))


def _oct_split_gather(x, table, resolutions, table_size: int):
    """(row ids per level, w [..., L, 8], the gathered bf16 rows [..., L, 8F])
    of unit-cube points [..., 3] in the per-level physical tables
    (`build_oct_tables_split`)."""
    idx_levels, w_all = _oct_local_indices_weights(x, resolutions, table_size)
    phys = build_oct_tables_split(table, resolutions, table_size)
    rows = torch.stack([phys[level][idx] for level, idx in enumerate(idx_levels)], dim=-2)
    return idx_levels, w_all, rows


def encode_oct_split(x, table, resolutions, table_size: int):
    """Hash-encode unit-cube points [..., 3] -> [..., L*F] through the
    per-level bf16 physical tables: the plain osplit forward, which K4
    computes bit for bit on the card."""
    _, w_all, rows = _oct_split_gather(x, table, resolutions, table_size)
    return _blend_levels(_level_feats(rows, table.shape[-1]), w_all)


# ---- row sums ------------------------------------------------------------


def _cumsum_rows(v: torch.Tensor) -> torch.Tensor:
    """torch.cumsum of [n, lanes] along n, one lane at a time: on the GPU
    PyTorch scans a 1-D tensor with CUB, while a scan along the long axis of
    a narrow 2-D array runs a handful of threads per lane."""
    return torch.stack([torch.cumsum(v[:, j].contiguous(), dim=0) for j in range(v.shape[1])],
                       dim=1)


def _sentinel_row_sums(idx: torch.Tensor, vals: torch.Tensor, n_rows: int, scan) -> torch.Tensor:
    """Sums of `vals` [m, lanes] per row id `idx` [m] in [0, n_rows), by the
    reference's sentinel pipeline: one stable sort of the data keys 2 idx
    and one sentinel key 2 r + 1 per row; the values gathered in that order
    (sentinels carry 0) and prefix-summed in f32 by `scan`, so the prefix at
    row r's sentinel is the total of rows <= r; a stable partition moves
    the sentinels (in row order) to the front; row sums are adjacent
    differences. The reference's variants differ in which operands ride
    their sorts; a torch sort returns a permutation and values follow by
    one gather, so all are this function."""
    m, lanes = vals.shape
    rows = torch.arange(n_rows, device=idx.device, dtype=idx.dtype)
    sorted_keys, pos = torch.sort(torch.cat([idx * 2, rows * 2 + 1]), stable=True)
    gathered = vals[torch.clamp(pos, max=m - 1)].to(torch.float32)
    csum = scan(torch.where((pos < m)[:, None], gathered, 0.0))
    _, order = torch.sort((sorted_keys & 1) ^ 1, stable=True)
    at_sentinel = csum[order[:n_rows]]
    return at_sentinel - torch.cat([at_sentinel.new_zeros((1, lanes)), at_sentinel[:-1]], dim=0)


def _sorted_row_sums(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row sums of the corner and quad table gradients (the reference's
    `_sorted_row_sums` and `_sorted_row_sums_gather`), scanned in f32 with
    torch.cumsum."""
    return _sentinel_row_sums(idx, vals, n_rows, _cumsum_rows)


def _segment_sums(sorted_idx: torch.Tensor, csum: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row sums from row ids sorted ascending and the prefix sums of their
    values in that order: with b_r = #(idx <= r), row r's sum is
    csum[b_r - 1] - csum[b_{r-1} - 1]. The reference finds b_r with two
    sentinel sorts; `searchsorted` on the sorted ids gives the same integers."""
    return _sums_at_ends(csum, _segment_ends(sorted_idx, n_rows))


def _segment_ends(sorted_idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """b_r = #(idx <= r) for each row r < n_rows, from the sorted row ids."""
    rows = torch.arange(n_rows, device=sorted_idx.device, dtype=sorted_idx.dtype)
    return torch.searchsorted(sorted_idx, rows, right=True)


def _sums_at_ends(csum: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Row sums: the prefix sums at the segment ends, differenced."""
    ge = torch.where((ends > 0)[:, None], csum[torch.clamp(ends - 1, min=0)], 0.0)
    return ge - torch.cat([ge.new_zeros((1, csum.shape[-1])), ge[:-1]], dim=0)


def _oct_split_row_sums(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Sums of `vals` [m, lanes] per row id `idx` [m] in [0, n_rows), scatter-free.

    Each value is first rounded to bf16, as in the reference; the values
    sorted by row are prefix-summed in f32 (K2a on the GPU) and differenced
    at the segment ends.
    """
    sorted_idx, order = torch.sort(idx)
    vals = vals.to(torch.bfloat16)[order].to(torch.float32)
    return _segment_sums(sorted_idx, prefix_scan.cumsum(vals), n_rows)


def _oct_split_table_grad_per_level(idx_levels, w_all: torch.Tensor, g_lf: torch.Tensor,
                                    resolutions, table_size: int) -> torch.Tensor:
    """The osplit table gradient level by level, as the backward ran it
    before its one pass: a sort, bf16 products, a scan (K2a on the GPU) and
    a roll fold a level. The osplit backward probe times it and the tests
    hold the one pass against it."""
    n_feats = g_lf.shape[-1]
    level_rows = _oct_level_rows(resolutions, table_size)
    return torch.stack([
        _fold(_oct_split_row_sums(
            idx_levels[level].reshape(-1),
            (w_all[..., level, :, None] * g_lf[..., level, None, :]).reshape(-1, 8 * n_feats),
            level_rows[level]), _oct_offsets(res, table_size), table_size, n_feats)
        for level, res in enumerate(resolutions)])


def _oct_split_row_sums_merged(idx: torch.Tensor, vals: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """The same row sums by the reference's "merged" pipeline: one sort
    interleaving data and sentinel keys, one scan (K2a on the GPU) over
    m + n_rows rows. Only the osplit backward probe calls it."""
    return _sentinel_row_sums(idx, vals.to(torch.bfloat16), n_rows, prefix_scan.cumsum)


def _fold(packed: torch.Tensor, offsets, table_size: int, n_feats: int) -> torch.Tensor:
    """Fold physical-row sums [rows, len(offsets) F] back onto the canonical
    level [T, F]: canonical row j collects lane c of physical row
    j - offsets[c]. Trimmed dense levels are padded back to T first; their
    wrapped rows land on that zero padding."""
    p = F.pad(packed, (0, 0, 0, table_size - packed.shape[0]))
    acc = p[:, :n_feats]
    for lane, o in enumerate(offsets[1:], start=1):
        acc = acc + torch.roll(p[:, lane * n_feats:(lane + 1) * n_feats], o, dims=0)
    return acc


def _fold_oct_levels(seg: torch.Tensor, resolutions, table_size: int,
                     n_feats: int) -> torch.Tensor:
    """The oct table's row sums [sum of level rows, 8F], folded back onto
    the canonical [L, T, F] table level by level."""
    level_rows = _oct_level_rows(resolutions, table_size)
    return torch.stack([_fold(p, _oct_offsets(res, table_size), table_size, n_feats)
                        for p, res in zip(torch.split(seg, level_rows), resolutions)])


def _oct_vals(w_all: torch.Tensor, g_lf: torch.Tensor) -> torch.Tensor:
    """[m, 8F] products of the corner weights and the cotangent, one row a
    point and level (m = points x L)."""
    return (w_all[..., None] * g_lf[..., None, :]).reshape(-1, 8 * g_lf.shape[-1])


def _oct_table_grad(idx: torch.Tensor, w_all: torch.Tensor, g_lf: torch.Tensor, resolutions,
                    table_size: int) -> torch.Tensor:
    """The oct layout's table gradient [L, T, F]: the values sorted stably
    by physical row, prefix-summed in f32 (K2a on the GPU), differenced at
    the segment ends and folded back onto the canonical table."""
    sorted_idx, order = torch.sort(idx.reshape(-1), stable=True)
    seg = _segment_sums(sorted_idx, prefix_scan.cumsum(_oct_vals(w_all, g_lf)[order]),
                        sum(_oct_level_rows(resolutions, table_size)))
    return _fold_oct_levels(seg, resolutions, table_size, g_lf.shape[-1])


def _level_keys(idx_levels, table_size: int) -> torch.Tensor:
    """int32 [L, P]: each level's row ids offset by l T, the keys of the
    backward's one sort (K4 writes them on the card). int32 keys take half
    the radix passes of int64; the level offsets are made on the device."""
    n_levels = len(idx_levels)
    if n_levels * table_size > torch.iinfo(torch.int32).max:
        raise ValueError(f"{n_levels} levels of {table_size} rows overflow the int32 sort keys")
    keys = torch.stack([i.reshape(-1) for i in idx_levels]).to(torch.int32)
    keys += torch.arange(0, n_levels * table_size, table_size, dtype=torch.int32,
                         device=keys.device)[:, None]
    return keys


def _sorted_level_keys(keys: torch.Tensor):
    """(sorted keys, order) of the level-offset keys [L, P]: level l's P
    entries fill positions l P to (l + 1) P of one sort, by physical row."""
    return torch.sort(keys.reshape(-1))


def _level_segment_ends(sorted_keys: torch.Tensor, n_levels: int, table_size: int):
    """int32 [L T]: the count of sorted keys at or below each level-offset
    row, a flat position from which level l's entries start at l P."""
    rows = torch.arange(n_levels * table_size, dtype=torch.int32, device=sorted_keys.device)
    return torch.searchsorted(sorted_keys, rows, right=True, out_int32=True)


def _oct_split_table_grad(keys: torch.Tensor, w_all: torch.Tensor, g_lf: torch.Tensor,
                          resolutions, table_size: int) -> torch.Tensor:
    """The osplit table gradient [L, T, F] in one pass over all levels: one
    sort of the level-offset row keys [L, P] (`_level_keys`), their
    bf16-rounded products in that order by K3a ([L, P, 8F]), each level's
    prefix sums by one K2b launch, the segment ends by one `searchsorted`,
    and the row sums folded back onto the canonical rows by K3b, which
    takes the levels' corner offsets and row counts by value: nothing waits
    for the device."""
    n_levels, n_feats = g_lf.shape[-2:]
    sorted_keys, order = _sorted_level_keys(keys)
    vals = hashgrid_grad.sorted_products(order, w_all.reshape(-1, n_levels, 8),
                                         g_lf.reshape(-1, n_levels, n_feats))
    csum = prefix_scan.cumsum_batched(vals)
    ends = _level_segment_ends(sorted_keys, n_levels, table_size)
    offsets = [_oct_offsets(res, table_size) for res in resolutions]
    tracing.count("hashgrid.grad_levels", n_levels)
    return hashgrid_grad.fold_segments(csum, ends, offsets,
                                       _oct_level_rows(resolutions, table_size), table_size)


def _trilinear_dx(x: torch.Tensor, resolutions, s: torch.Tensor) -> torch.Tensor:
    """dL/dx from per-corner sums s [..., L, 8] in lane order:
    dw/dx_d = res sign_d prod_{d' != d} f_d'."""
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


def _corner_sums(g_lf: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """s [..., L, 8] = sum_F g [..., L, F] feats [..., L, 8, F]: the
    cotangent of the weights."""
    return torch.sum(g_lf[..., None, :] * feats, dim=-1)


def _cotangent(g: torch.Tensor, n_levels: int, n_feats: int) -> torch.Tensor:
    return g.to(torch.float32).reshape(g.shape[:-1] + (n_levels, n_feats))


# ---- sorted-gradient encodings ------------------------------------------


def _oct_split_forward_plain(x, table, resolutions, table_size: int, dtype=torch.float32,
                             keys: bool = False, rows: bool = False):
    """K4's plain twin on points x [P, 3]: (features [P, L F] in `dtype` as
    `encode_oct_split` computes them, the level-offset row keys [L, P] and
    the weights [P, L, 8] if `keys`, the gathered bf16 corner rows [P, L,
    8F] if `rows`; None for what is not asked for)."""
    idx_levels, w_all, gathered = _oct_split_gather(x, table, resolutions, table_size)
    out = _blend_levels(_level_feats(gathered, table.shape[-1]), w_all).to(dtype)
    level_keys = _level_keys(idx_levels, table_size) if keys else None
    return out, level_keys, w_all if keys else None, gathered if rows else None


def _oct_split_forward(x, table, resolutions, table_size: int, dtype=torch.float32,
                       keys: bool = False, rows: bool = False):
    """(features [..., L F] in `dtype`, keys [L, P], w_all [P, L, 8], rows
    [P, L, 8F] or None each) of points [..., 3] (P of them): one K4 launch
    over all levels on the card, which takes each level's dense stride and
    the row offsets of its corner pairs by value; its plain twin on the CPU.
    Counts the levels it encodes in one pass (`hashgrid.fwd_levels`)."""
    n_levels, _, n_feats = table.shape
    points = x.reshape(-1, 3)
    if cuda_build.use_kernel(table, "osplit encode"):
        # Corners 2k and 2k + 1 differ in z alone: rows o and o + 1.
        strides = [int(r) + 1 if _is_dense(int(r), table_size) else 0 for r in resolutions]
        pairs = [o for r in resolutions for o in _oct_offsets(int(r), table_size)[::2]]
        out, *saved = hashgrid_grad.oct_split_encode_cuda(
            points.contiguous(), table.contiguous(), resolutions, strides, pairs, dtype, keys,
            rows)
    else:
        out, *saved = _oct_split_forward_plain(points, table, resolutions, table_size, dtype,
                                               keys, rows)
    tracing.count("hashgrid.fwd_levels", n_levels)
    return (out.reshape(x.shape[:-1] + (n_levels * n_feats,)), *saved)


def encode_osplit(x, table, resolutions, table_size: int, dtype=torch.float32,
                  sorted_grad: bool = True):
    """The osplit encode as the module runs it, features in `dtype`.

    Without a gradient, the features alone, nothing kept (a Function cannot
    tell: its `needs_input_grad` reads requires_grad, also under no_grad).
    Under autograd the sorted mode runs OctSplitEncode, which keeps what its
    backward reads; the scatter mode differentiates `encode_oct_split`'s
    gathers, on the CPU only: on the card every osplit encode is K4, which
    keeps no gather to differentiate.
    """
    if not (torch.is_grad_enabled() and (x.requires_grad or table.requires_grad)):
        return _oct_split_forward(x, table, resolutions, table_size, dtype)[0]
    if sorted_grad:
        return OctSplitEncode.apply(x, table, resolutions, table_size, dtype)
    if table.is_cuda:
        raise ValueError("grad_mode='scatter' takes the osplit layout on the CPU only; on the "
                         "card use grad_mode 'auto' or 'sorted', or another layout")
    return encode_oct_split(x, table, resolutions, table_size).to(dtype)


class OctSplitEncode(torch.autograd.Function):
    """encode_oct_split (K4 on the card) with the sorted-segment table
    gradient over all levels in one pass (one sort, K3a, one K2b launch,
    K3b). The forward keeps the level-offset row keys and the weights where
    the table needs a gradient, the bf16 corner rows where the points do."""

    @staticmethod
    def forward(ctx, x, table, resolutions, table_size, dtype=torch.float32):
        want_x, want_table = ctx.needs_input_grad[:2]
        out, keys, w_all, rows = _oct_split_forward(x, table, resolutions, table_size, dtype,
                                                    keys=want_table, rows=want_x)
        ctx.save_for_backward(x, keys, w_all, rows)
        ctx.resolutions, ctx.table_size = tuple(int(r) for r in resolutions), table_size
        ctx.table_shape = table.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, keys, w_all, rows = ctx.saved_tensors
        resolutions, table_size = ctx.resolutions, ctx.table_size
        n_levels, _, n_feats = ctx.table_shape
        g_lf = _cotangent(g, n_levels, n_feats).reshape(-1, n_levels, n_feats)
        canon = dx = None
        if ctx.needs_input_grad[1]:
            canon = _oct_split_table_grad(keys, w_all, g_lf, resolutions, table_size)
        if ctx.needs_input_grad[0]:
            s = _corner_sums(g_lf, _level_feats(rows, n_feats))
            dx = _trilinear_dx(x.reshape(-1, 3), resolutions, s).reshape(x.shape)
        return dx, canon, None, None, None


class OctEncode(torch.autograd.Function):
    """encode_oct with one sorted-segment table gradient over all levels:
    one data sort, one value gather, one K2a scan of [points x L, 8F] in
    f32, the segment ends, and a roll fold per level."""

    @staticmethod
    def forward(ctx, x, table, resolutions, table_size):
        idx, w_all = _oct_indices_weights(x, resolutions, table_size)
        rows = build_oct_table(table, resolutions, table_size)[idx]  # [..., L, 8F]
        ctx.save_for_backward(x, idx, w_all, rows)
        ctx.resolutions, ctx.table_size = tuple(int(r) for r in resolutions), table_size
        ctx.table_shape = table.shape
        return _blend_levels(rows.reshape(rows.shape[:-1] + (8, table.shape[-1])), w_all)

    @staticmethod
    def backward(ctx, g):
        x, idx, w_all, rows = ctx.saved_tensors
        resolutions, table_size = ctx.resolutions, ctx.table_size
        n_levels, _, n_feats = ctx.table_shape
        g_lf = _cotangent(g, n_levels, n_feats)
        canon = _oct_table_grad(idx, w_all, g_lf, resolutions, table_size)
        dx = None
        if ctx.needs_input_grad[0]:
            s = _corner_sums(g_lf, rows.reshape(rows.shape[:-1] + (8, n_feats)))
            dx = _trilinear_dx(x, resolutions, s)
        return dx, canon, None, None


class QuadEncode(torch.autograd.Function):
    """encode_quad with the sorted-segment gradient over the quad rows,
    folded back by four rolls; the analytic (cx, quad lane) dx."""

    @staticmethod
    def forward(ctx, x, table, resolutions, table_size):
        idx, w_all = _quad_indices_weights(x, resolutions, table_size)
        feats = _gather_quad(build_quad_table(table, resolutions, table_size), idx,
                             table.shape[-1])
        ctx.save_for_backward(x, idx, w_all, feats)
        ctx.resolutions, ctx.table_size = tuple(int(r) for r in resolutions), table_size
        ctx.table_shape = table.shape
        return _blend_levels(feats, w_all)

    @staticmethod
    def backward(ctx, g):
        x, idx, w_all, feats = ctx.saved_tensors
        resolutions, table_size = ctx.resolutions, ctx.table_size
        n_levels, _, n_feats = ctx.table_shape
        g_lf = _cotangent(g, n_levels, n_feats)
        vals = (w_all[..., None] * g_lf[..., None, :]).reshape(-1, 4 * n_feats)
        pg = _sorted_row_sums(idx.reshape(-1), vals, n_levels * table_size)
        pg = pg.reshape(n_levels, table_size, 4 * n_feats)
        canon = [_fold(pg[level], _oct_offsets(res, table_size)[:4], table_size, n_feats)
                 for level, res in enumerate(resolutions)]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _quad_dx(x, resolutions, _corner_sums(g_lf, feats))
        return dx, torch.stack(canon), None, None


class CornerEncode(torch.autograd.Function):
    """encode (corner hash) with the sorted-segment gradient over the
    canonical rows; the analytic trilinear dx."""

    @staticmethod
    def forward(ctx, x, table, resolutions, table_size):
        idx, w_all = _corner_indices_weights(x, resolutions, table_size)
        feats = table.reshape(-1, table.shape[-1])[idx]  # [..., L, 8, F]
        ctx.save_for_backward(x, idx, w_all, feats)
        ctx.resolutions = tuple(int(r) for r in resolutions)
        ctx.table_shape = table.shape
        return _blend_levels(feats, w_all)

    @staticmethod
    def backward(ctx, g):
        x, idx, w_all, feats = ctx.saved_tensors
        n_levels, table_size, n_feats = ctx.table_shape
        g_lf = _cotangent(g, n_levels, n_feats)
        vals = (w_all[..., None] * g_lf[..., None, :]).reshape(-1, n_feats)
        dtable = _sorted_row_sums(idx.reshape(-1), vals, n_levels * table_size)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _trilinear_dx(x, ctx.resolutions, _corner_sums(g_lf, feats))
        return dx, dtable.reshape(ctx.table_shape), None, None


_ENCODE = {"oct": encode_oct, "quad": encode_quad}
_SORTED = {"oct": OctEncode, "quad": QuadEncode}
_PREPARE = {"oct": build_oct_table, "quad": build_quad_table}


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
        if layout != "corner" and pack_rows > 1:
            # The packed path reads indices under the corner hash.
            raise ValueError(f"layout={layout!r} is incompatible with pack_rows>1 (the packed "
                             "path uses the corner hash); set pack_rows=0 or layout='corner'")
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"unknown grad_mode {grad_mode!r}; expected one of {GRAD_MODES}")
        self.layout = layout
        self.sorted_grad = grad_mode != "scatter"
        self.compute_dtype = mathx.as_dtype(compute_dtype)
        self.table_size = 2**log2_table_size
        # A pack that does not divide L*T is off, as in the reference.
        pack = max(pack_rows, 0)
        self.pack_rows = pack if pack > 1 and (n_levels * self.table_size) % pack == 0 else 0
        self.resolutions = tuple(
            int(r) for r in level_resolutions(n_levels, base_resolution, max_resolution)
        )
        table = torch.empty(n_levels, self.table_size, n_features)
        self.table = nn.Parameter(table.uniform_(-init_scale, init_scale, generator=generator))

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * self.table.shape[2]

    def prepare(self):
        """The packed physical table(s), for repeated encodes of frozen
        weights; None where nothing is packed: the corner layout, and osplit,
        whose forward (K4 on the card) reads the canonical table."""
        if self.layout in ("corner", "osplit"):
            return None
        with torch.no_grad():
            return _PREPARE[self.layout](self.table, self.resolutions, self.table_size)

    def forward(self, x, prepared=None):
        args = (x, self.table, self.resolutions, self.table_size)
        if self.layout == "corner":
            if self.sorted_grad and not self.pack_rows:
                out = CornerEncode.apply(*args)
            else:
                out = encode(*args, pack_rows=self.pack_rows)
        elif self.layout == "osplit":
            return encode_osplit(*args, self.compute_dtype, self.sorted_grad)
        elif prepared is not None:
            out = _ENCODE[self.layout](*args, prepared)
        elif self.sorted_grad:
            out = _SORTED[self.layout].apply(*args)
        else:
            out = _ENCODE[self.layout](*args)
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
