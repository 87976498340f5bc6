"""The port's occupancy grid, marching and compaction against the reference
package on the CPU, with the same numpy inputs (and, for the grid refresh,
the reference's own random cells and jitter handed to the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import occupancy as t_occ
from outdoor_nerf_depth_tpu.ops import occupancy as j_occ

torch.set_num_threads(1)

SCALE = 8.0  # the KITTI NGP config: 5 cascades


def _points(n, seed, spread=6.0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * spread).astype(np.float32)


def test_cascades_and_cells():
    assert t_occ.num_cascades(SCALE) == j_occ.num_cascades(SCALE) == 5
    np.testing.assert_array_equal(t_occ.cascade_extents(SCALE), j_occ.cascade_extents(SCALE))
    x = _points(4096, 0)
    x[:4] = [[0.0, 0, 0], [0.5, 0, 0], [-1.0, 2.0, 0], [8.0, -8.0, 8.0]]  # cascade edges
    casc_j = j_occ.point_cascade(jnp.asarray(x), SCALE)
    casc_t = t_occ.point_cascade(torch.from_numpy(x), SCALE)
    np.testing.assert_array_equal(casc_t.numpy(), np.asarray(casc_j))
    flat_j, cell_j = j_occ.cell_index(jnp.asarray(x), casc_j, SCALE, 32)
    flat_t, cell_t = t_occ.cell_index(torch.from_numpy(x), casc_t, SCALE, 32)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(cell_t.numpy(), np.asarray(cell_j))


def test_lookup_and_mean_density():
    grid = np.random.default_rng(1).uniform(-0.5, 1.0, (5, 16**3)).astype(np.float32)
    x = _points(2048, 2)
    want = j_occ.lookup(jnp.asarray(grid), jnp.asarray(x), SCALE, 0.3)
    got = t_occ.lookup(torch.from_numpy(grid), torch.from_numpy(x), SCALE, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(t_occ.mean_density(torch.from_numpy(grid))),
                               float(j_occ.mean_density(jnp.asarray(grid))), rtol=1e-6)
    assert t_occ.init_grid(SCALE, 8).shape == (5, 512)


def test_intersect_aabb():
    rng = np.random.default_rng(3)
    o = (rng.normal(size=(256, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [1.0, 0.0, 0.0]  # axis-aligned: two zero components
    for a, b in zip(t_occ.intersect_aabb(torch.from_numpy(o), torch.from_numpy(d), SCALE),
                    j_occ.intersect_aabb(jnp.asarray(o), jnp.asarray(d), SCALE)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("exponential", [True, False])
def test_march_candidates(exponential):
    rng = np.random.default_rng(4)
    t0 = rng.uniform(0.01, 1.0, 64).astype(np.float32)
    t1 = t0 + rng.uniform(0.5, 20.0, 64).astype(np.float32)
    want = j_occ.march_candidates(None, jnp.asarray(t0), jnp.asarray(t1), 128, exponential)
    got = t_occ.march_candidates(None, torch.from_numpy(t0), torch.from_numpy(t1), 128,
                                 exponential)
    # pow / fma in another library: a few ulps.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    jittered = t_occ.march_candidates(torch.Generator().manual_seed(0), torch.from_numpy(t0),
                                      torch.from_numpy(t1), 128, exponential)
    assert torch.all(torch.diff(jittered, dim=-1) > 0)
    np.testing.assert_array_equal(jittered[:, [0, -1]].numpy(), got[:, [0, -1]].numpy())


@pytest.mark.parametrize("subsample", [True, False])
def test_compact_occupied(subsample):
    rng = np.random.default_rng(5)
    edges = np.sort(rng.uniform(0.1, 10.0, (48, 65)), axis=-1).astype(np.float32)
    density = rng.uniform(size=(48, 1))  # rays from nearly empty to nearly full
    occupied = rng.uniform(size=(48, 64)) < density
    occupied[0] = False
    want = j_occ.compact_occupied(jnp.asarray(edges), jnp.asarray(occupied), 16, subsample)
    got = t_occ.compact_occupied(torch.from_numpy(edges), torch.from_numpy(occupied), 16,
                                 subsample)
    assert int(occupied.sum(-1).max()) > 16  # some rays over the budget
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("budget", [40, 150])  # overflowing, exact (of 192 slots)
def test_batch_compaction_and_expand(budget):
    rng = np.random.default_rng(6)
    valid = rng.uniform(size=(16, 12)) < 0.5
    sel_j, inv_j = j_occ.batch_compaction_plan(jnp.asarray(valid), budget)
    sel_t, inv_t = t_occ.batch_compaction_plan(torch.from_numpy(valid), budget)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    if budget >= valid.sum():  # exact: every valid slot is selected
        assert set(sel_t[: valid.sum()].tolist()) == set(np.flatnonzero(valid).tolist())

    vals = rng.normal(size=(budget, 4)).astype(np.float32)
    cot = rng.normal(size=(valid.size, 4)).astype(np.float32)
    dense_j, vjp = jax.vjp(lambda v: j_occ.expand_compacted(v, inv_j, sel_j), jnp.asarray(vals))
    (grad_j,) = vjp(jnp.asarray(cot))
    vt = torch.from_numpy(vals).requires_grad_(True)
    dense_t = t_occ.expand_compacted(vt, inv_t, sel_t)
    (dense_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(dense_t.detach().numpy(), np.asarray(dense_j))
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(grad_j))


def _density_j(p):
    return 5.0 * jnp.exp(-jnp.sum(p**2, axis=-1) / 8.0) - 1.0


def _density_t(p):
    return 5.0 * torch.exp(-torch.sum(p**2, dim=-1) / 8.0) - 1.0


@pytest.mark.parametrize("n_per_cascade", [0, 500])  # warmup sweep, sampled refresh
def test_update_grid_with_the_reference_draws(n_per_cascade):
    res = 12
    grid = np.random.default_rng(7).uniform(-0.1, 2.0, (5, res**3)).astype(np.float32)
    grid[:, :7] = -1.0  # culled cells stay culled
    rng = jax.random.PRNGKey(9)
    want = j_occ.update_grid(rng, jnp.asarray(grid), _density_j, SCALE, decay=0.9,
                             n_per_cascade=n_per_cascade, threshold=0.5, chunk=1000)
    # The reference's own draws, as `update_grid` makes them.
    rng_cells, rng_jitter = jax.random.split(rng)
    if n_per_cascade:
        cells = j_occ.sample_update_cells(rng_cells, jnp.asarray(grid), n_per_cascade, 0.5)
    else:
        cells = jnp.broadcast_to(jnp.arange(res**3), (5, res**3))
    jitter = jax.random.uniform(rng_jitter, cells.shape + (3,))
    got = t_occ.update_grid(torch.from_numpy(grid), _density_t, SCALE, decay=0.9,
                            n_per_cascade=n_per_cascade, threshold=0.5, chunk=1000,
                            cells=torch.from_numpy(np.array(cells)).to(torch.int64),
                            jitter=torch.from_numpy(np.array(jitter)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert np.all(got.numpy()[:, :7] == -1.0)


def test_sample_update_cells():
    grid = torch.zeros((2, 1000))
    grid[0, 100:110] = 1.0  # cascade 0: ten occupied cells; cascade 1: none
    gen = torch.Generator().manual_seed(0)
    cells = t_occ.sample_update_cells(gen, grid, 40, 0.5)
    assert cells.shape == (2, 40) and cells.min() >= 0 and cells.max() < 1000
    assert set(cells[0, 20:30].tolist()) == set(range(100, 110))  # the occupied half
    full = t_occ.update_grid(grid, lambda p: torch.ones(p.shape[0]), 1.0,
                             n_per_cascade=40, threshold=0.5, generator=gen)
    assert full.shape == grid.shape and int((full == 1.0).sum()) <= 80
