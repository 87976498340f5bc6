"""Multi-cascade occupancy grid and fixed-width masked ray marching.

Port of the train-path parts of the reference package's `ops/occupancy.py`.
The grid is a dense [cascades, R^3] float32 density EMA; cascade c covers
the cube [-e_c, e_c]^3 with e_c = min(scale, 2^(c-1)), and a point belongs
to the smallest cascade that holds it. Each ray draws a fixed number of
candidate intervals, looks each one up in the grid, and keeps up to
`max_samples` occupied ones in marching order (`compact_occupied`). A batch
can then run the field only on its valid sample slots
(`batch_compaction_plan`, `expand_compacted`).

Random draws (jitter, refreshed cells) come from a `torch.Generator`;
`update_grid` also takes the cells and the jitter from its caller, so a
test can feed it the reference's draws. `calc_dt` spaces the iterative eval
renderer's candidates. `mark_invisible_cells` culls the cells no training
camera sees (nothing in the train loop calls it, as in the reference), and
`morton3d` / `morton3d_invert` are the reference's Z-order codes.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

SQRT3 = float(np.sqrt(3.0))
# The compaction sort key puts invalid slots after valid ones with this
# offset, as the reference does; the plan is exact for max_samples <= 256.
_INVALID_KEY = 256


# Morton codes: the reference's uint32 arithmetic in int64. Every mask
# constant lies within 32 bits, so masking after each multiply also wraps it
# to uint32 as the reference's does.
_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the reference's wraparound."""
    v = v & _U32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer grid coords (10 bits each) -> int32 Z-order index."""
    c = coords.to(torch.int64) & _U32
    code = _expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1) | (_expand_bits(c[..., 2]) << 2)
    return _as_int32(code)


def _compact_bits(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x49249249
    v = (v ^ (v >> 2)) & 0xC30C30C3
    v = (v ^ (v >> 4)) & 0x0F00F00F
    v = (v ^ (v >> 8)) & 0xFF0000FF
    return (v ^ (v >> 16)) & 0x000003FF


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of morton3d: int32 Z-order index -> [..., 3] int32 coords."""
    c = codes.to(torch.int64) & _U32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1), _compact_bits(c >> 2)],
                       dim=-1).to(torch.int32)


def num_cascades(scale: float) -> int:
    return max(1 + int(np.ceil(np.log2(max(2 * scale, 1e-8)))), 1)


def cascade_extents(scale: float) -> np.ndarray:
    return np.minimum(scale, 2.0 ** (np.arange(num_cascades(scale)) - 1))


def point_cascade(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Smallest cascade index whose cube contains each point [..., 3]."""
    maxc = torch.amax(torch.abs(x), dim=-1)
    casc = torch.ceil(torch.log2(torch.clamp(maxc, min=1e-8)) + 1.0).to(torch.int64)
    return torch.clamp(casc, 0, num_cascades(scale) - 1)


def cell_index(x: torch.Tensor, cascade: torch.Tensor, scale: float, resolution: int):
    """(flat cell index, cell [..., 3]) of each point within its cascade's grid."""
    extent = torch.clamp(torch.pow(2.0, cascade.to(torch.float32) - 1.0), max=scale)
    u = (x / (2.0 * extent[..., None]) + 0.5) * resolution
    cell = torch.clamp(u.to(torch.int64), 0, resolution - 1)
    flat = cell[..., 0] * resolution * resolution + cell[..., 1] * resolution + cell[..., 2]
    return flat, cell


def grid_resolution(density_grid: torch.Tensor) -> int:
    return int(round(density_grid.shape[-1] ** (1.0 / 3.0)))


def lookup(density_grid: torch.Tensor, x: torch.Tensor, scale: float, threshold) -> torch.Tensor:
    """Occupancy of world points: density EMA above threshold. bool [...]."""
    casc = point_cascade(x, scale)
    flat, _ = cell_index(x, casc, scale, grid_resolution(density_grid))
    return density_grid[casc, flat] > threshold


def init_grid(scale: float, resolution: int = 128, device=None) -> torch.Tensor:
    """A fresh grid [cascades, R^3], zero everywhere: nothing is occupied
    until the first refresh (see `mean_density`)."""
    return torch.zeros((num_cascades(scale), resolution**3), dtype=torch.float32, device=device)


def sample_update_cells(generator, density_grid: torch.Tensor, n_per_cascade: int,
                        threshold: float) -> torch.Tensor:
    """Cells to refresh [C, M]: half uniform, half drawn from the occupied
    cells (Gumbel top-k), uniform again for a cascade with none occupied."""
    c, n_cells = density_grid.shape
    n_per_cascade = min(n_per_cascade, n_cells)
    k_uniform = n_per_cascade // 2
    k_occ = n_per_cascade - k_uniform
    dev = density_grid.device
    uniform = torch.randint(0, n_cells, (c, k_uniform), generator=generator, device=dev)
    occ = density_grid > threshold
    u = torch.rand((c, n_cells), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    scores = torch.where(occ, gumbel, float("-inf"))
    occupied_idx = torch.topk(scores, k_occ, dim=-1).indices
    fallback = torch.randint(0, n_cells, (c, k_occ), generator=generator, device=dev)
    occupied_idx = torch.where(occ.any(dim=-1, keepdim=True), occupied_idx, fallback)
    return torch.cat([uniform, occupied_idx], dim=-1)


def cell_centers(cells: torch.Tensor, scale: float, resolution: int,
                 jitter: torch.Tensor) -> torch.Tensor:
    """World positions [C, M, 3] of flat cells [C, M] per cascade, moved
    within the cell by `jitter` [C, M, 3] in [0, 1)."""
    coords = torch.stack(
        [cells // (resolution * resolution), (cells // resolution) % resolution,
         cells % resolution],
        dim=-1,
    ).to(torch.float32)
    u = (coords + jitter) / resolution - 0.5
    extents = torch.as_tensor(cascade_extents(scale), dtype=torch.float32, device=cells.device)
    return u * 2.0 * extents[:, None, None]


def update_grid(
    density_grid: torch.Tensor,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    scale: float,
    decay: float = 0.95,
    n_per_cascade: int = 0,
    threshold: float = 0.01,
    chunk: int = 131_072,
    generator: Optional[torch.Generator] = None,
    cells: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One refresh: decay every cell, then scatter-max fresh densities.

    `density_fn(points [M, 3]) -> sigma [M]` runs on slabs of `chunk`
    points. `n_per_cascade=0` refreshes every cell (warmup), otherwise
    `sample_update_cells` picks them; `cells` and `jitter` override the
    draws. Cells below zero (culled) stay as they are. Returns a new grid.
    """
    c, n_cells = density_grid.shape
    dev = density_grid.device
    if cells is None:
        if n_per_cascade <= 0:
            cells = torch.arange(n_cells, device=dev).expand(c, n_cells)
        else:
            cells = sample_update_cells(generator, density_grid, n_per_cascade, threshold)
    if jitter is None:
        jitter = torch.rand(cells.shape + (3,), generator=generator, device=dev)
    pts = cell_centers(cells, scale, grid_resolution(density_grid), jitter).reshape(-1, 3)
    sigma = torch.cat([density_fn(pts[i:i + chunk]) for i in range(0, pts.shape[0], chunk)])
    flat = (torch.arange(c, device=dev)[:, None] * n_cells + cells).reshape(-1)
    updated = (density_grid * decay).reshape(-1).scatter_reduce(
        0, flat, torch.clamp(sigma.reshape(-1), min=0.0), "amax", include_self=True
    )
    return torch.where(density_grid < 0, density_grid, updated.reshape(c, n_cells))


def mark_invisible_cells(density_grid: torch.Tensor, camtoworlds: torch.Tensor,
                         intrinsics: torch.Tensor, width: int, height: int, scale: float,
                         near: float = 0.01, chunk: int = 262_144) -> torch.Tensor:
    """Cull the cells no training camera sees: every cell centre of every
    cascade is projected into every camera (`camtoworlds` [N, 3, 4], OpenGL
    convention: the camera looks down -z; `intrinsics` [3, 3]) in chunks of
    `chunk` cells; a cell in front of no camera's image gets the sentinel -1,
    which `update_grid` keeps. Returns a new grid [C, R^3]."""
    c, n_cells = density_grid.shape
    dev = density_grid.device
    resolution = grid_resolution(density_grid)
    cells = torch.arange(n_cells, device=dev)
    coords = torch.stack([cells // (resolution * resolution), (cells // resolution) % resolution,
                          cells % resolution], dim=-1).to(torch.float32)
    u = (coords + 0.5) / resolution - 0.5
    extents = torch.as_tensor(cascade_extents(scale), dtype=torch.float32, device=dev)
    rot, t = camtoworlds[:, :3, :3], camtoworlds[:, :3, 3]
    fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]
    new_grid = density_grid.clone()
    for ci in range(c):
        pts = u * 2.0 * extents[ci]
        visible = torch.zeros(n_cells, dtype=torch.bool, device=dev)
        for start in range(0, n_cells, chunk):
            rel = pts[None, start:start + chunk, :] - t[:, None, :]
            cam = torch.einsum("nij,nki->nkj", rot, rel)  # R^T (p - t)
            z = -cam[..., 2]
            depth = torch.clamp(z, min=near)
            x = fx * (cam[..., 0] / depth) + cx
            y = -fy * (cam[..., 1] / depth) + cy
            seen = (z > near) & (x >= 0) & (x < width) & (y >= 0) & (y < height)
            visible[start:start + chunk] = seen.any(dim=0)
        new_grid[ci] = torch.where(visible, new_grid[ci], -1.0)
    return new_grid


def mean_density(density_grid: torch.Tensor) -> torch.Tensor:
    """Mean density of cascade 0, the adaptive half of the min(mean,
    threshold) occupancy rule."""
    return torch.mean(torch.clamp(density_grid[0], min=0.0))


def batch_compaction_plan(valid: torch.Tensor, budget_total: int):
    """Which sample slots of a batch the field evaluates.

    A stable sort on key (not valid) * 256 + slot puts valid slots first,
    ordered by slot index within the ray: when more slots are valid than the
    budget, every ray loses its farthest samples alike. Returns (sel
    [budget] flat slot ids, inv [m] rank of each flat slot; >= budget means
    not evaluated).
    """
    m = valid.numel()
    slot = torch.arange(valid.shape[-1], device=valid.device).expand(valid.shape).reshape(m)
    key = torch.where(valid.reshape(m), 0, _INVALID_KEY) + slot
    order = torch.sort(key, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(m, device=valid.device)
    return order[:budget_total], inv


class _ExpandCompacted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals_c, inv, sel):
        ctx.save_for_backward(sel)
        budget = vals_c.shape[0]
        padded = torch.cat([vals_c, vals_c.new_zeros((1,) + vals_c.shape[1:])])
        return padded[torch.clamp(inv, max=budget)]

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return g[sel], None, None


def expand_compacted(vals_c: torch.Tensor, inv: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """[budget, C] -> [m, C] on the dense flat slots (unselected read 0).
    Its gradient is the opposite gather g[sel], not a scatter-add."""
    return _ExpandCompacted.apply(vals_c, inv, sel)


def intersect_aabb(ray_o, ray_d, half_extent: float, near_min: float = 0.01):
    """Slab test against the cube [-e, e]^3. Returns (t_near, t_far, hit)."""
    inv_d = 1.0 / torch.where(torch.abs(ray_d) < 1e-10, 1e-10, ray_d)
    t0 = (-half_extent - ray_o) * inv_d
    t1 = (half_extent - ray_o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_near = torch.clamp(t_near, min=near_min)
    return t_near, t_far, t_far > t_near


def calc_dt(t, exp_step_factor: float, max_samples: int, grid_size: int, scale: float):
    """The marching step at distance t: t * exp_step_factor clipped to
    [sqrt(3) / max_samples, sqrt(3) * 2 * scale / grid_size], where `scale` is
    the outermost cascade's half extent (a factor 0 gives the smallest step)."""
    return torch.clamp(t * exp_step_factor, SQRT3 / max_samples, SQRT3 * 2.0 * scale / grid_size)


def march_candidates(generator, t_near, t_far, n_candidates: int, exponential: bool = True):
    """Candidate interval edges [..., n+1] per ray, exponentially or evenly
    spaced; with a generator the interior edges move within half a step."""
    frac = torch.arange(n_candidates + 1, dtype=torch.float32, device=t_near.device) / n_candidates
    if exponential:
        ratio = torch.clamp(t_far / torch.clamp(t_near, min=1e-6), min=1.0 + 1e-6)
        edges = t_near[..., None] * ratio[..., None] ** frac
    else:
        edges = t_near[..., None] + (t_far - t_near)[..., None] * frac
    if generator is not None:
        widths = torch.diff(edges, dim=-1)
        u = torch.rand(widths[..., :-1].shape, generator=generator, device=edges.device) - 0.5
        interior = edges[..., 1:-1] + u * torch.minimum(widths[..., :-1], widths[..., 1:])
        edges = torch.cat([edges[..., :1], interior, edges[..., -1:]], dim=-1)
    return edges


def compact_occupied(edges, occupied, max_samples: int, subsample: bool = True):
    """Up to `max_samples` occupied intervals per ray, in marching order.

    With `subsample`, a ray with n > K occupied candidates keeps every k-th
    (k = ceil(n / K)) and scales their dt by k, so the samples span the whole
    segment. Returns (t_mid, dt, valid), each [..., K]; invalid slots are 0.
    """
    dt_scale = 1.0
    if subsample:
        n_occ = torch.sum(occupied, dim=-1, keepdim=True)
        k = torch.clamp((n_occ + max_samples - 1) // max_samples, min=1)
        rank = torch.cumsum(occupied, dim=-1) - 1
        occupied = occupied & (rank % k == 0)
        dt_scale = k.to(torch.float32)
    order = torch.sort(torch.where(occupied, 0, 1), dim=-1, stable=True).indices
    take = order[..., :max_samples]
    t0 = torch.gather(edges[..., :-1], -1, take)
    t1 = torch.gather(edges[..., 1:], -1, take)
    valid = torch.gather(occupied, -1, take)
    t_mid = 0.5 * (t0 + t1)
    dt = (t1 - t0) * dt_scale
    return torch.where(valid, t_mid, 0.0), torch.where(valid, dt, 0.0), valid
