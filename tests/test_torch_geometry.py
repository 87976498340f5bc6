"""The port's unit-sphere geometry against the reference package on the CPU:
exit distances and inverted-sphere background points for origins inside
the sphere, for camera rays of any length, for rays that graze the sphere,
and for inverse radii at 0, 0+ and 1.

Near the sphere's surface the functions are ill-conditioned: with |p_mid|
(the ray's closest point to the centre) within 1e-3 of 1, sqrt(1 - |p_mid|^2)
and asin(|p_mid| inv_r) turn a one-ulp change of |p_mid| into up to ~1e-4.
The reference's CPU kernels contract multiply-adds into FMAs and PyTorch's
do not, so their |p_mid| differ by an ulp now and then. Grazing rays are
therefore held to 1e-6 where the clamps decide the result, and elsewhere
against the same formulas in float64: the port's error is no larger than
the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import geometry as t_geometry
from outdoor_nerf_depth_tpu.ops import geometry as j_geometry

torch.set_num_threads(1)

N_RAYS, N_RADII = 64, 16


def _rays(case, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(N_RAYS, 3))
    o /= np.linalg.norm(o, axis=-1, keepdims=True)
    if case in ("inside", "unnormalized"):
        # Origins uniformly inside the sphere of radius 0.9, any direction.
        o *= 0.9 * rng.uniform(size=(N_RAYS, 1)) ** (1 / 3)
        d = rng.normal(size=(N_RAYS, 3))
    else:
        # Tangent at the origin, so the origin is the closest point: on or
        # just past the sphere ("touching") or just inside it ("near").
        lo, hi = {"touching": (1.0 + 1e-5, 1.0 + 1e-3), "near": (1.0 - 1e-3, 1.0 - 1e-5)}[case]
        o *= rng.uniform(lo, hi, (N_RAYS, 1))
        d = np.cross(o, rng.normal(size=(N_RAYS, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if case == "unnormalized":  # camera rays: |d| is not 1
        d *= rng.uniform(0.5, 2.0, (N_RAYS, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _radii(kind):
    return {"random": np.random.default_rng(5).uniform(0.0, 1.0, (N_RAYS, N_RADII)),
            "zero_plus": np.full((N_RAYS, N_RADII), 1e-7),
            "one": np.ones((N_RAYS, N_RADII)),
            "zero": np.zeros((N_RAYS, N_RADII))}[kind].astype(np.float32)


def _both(o, d, r, dtype=torch.float32):
    bo, bd = (np.ascontiguousarray(np.broadcast_to(x[:, None], r.shape + (3,))) for x in (o, d))
    t_pts, t_metric = t_geometry.inverted_sphere_points(
        *(torch.from_numpy(x).to(dtype) for x in (bo, bd, r)))
    j_pts, j_metric = j_geometry.inverted_sphere_points(*(jnp.asarray(x) for x in (bo, bd, r)))
    return (t_pts.numpy(), t_metric.numpy()), (np.asarray(j_pts), np.asarray(j_metric))


@pytest.mark.parametrize("case", ["inside", "unnormalized", "touching", "near"])
def test_intersect_unit_sphere_matches(case):
    o, d = _rays(case)
    t_exit, valid = t_geometry.intersect_unit_sphere(torch.from_numpy(o), torch.from_numpy(d))
    j_exit, j_valid = j_geometry.intersect_unit_sphere(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert np.all(valid.numpy() == (case != "touching"))  # touching rays miss the inside
    np.testing.assert_allclose(t_exit.numpy(), np.asarray(j_exit), rtol=1e-6, atol=1e-6)
    assert np.all(np.isfinite(t_exit.numpy()))


@pytest.mark.parametrize("case", ["inside", "unnormalized"])
@pytest.mark.parametrize("inv_r", ["random", "zero_plus", "one", "zero"])
def test_inverted_sphere_points_match(case, inv_r):
    o, d = _rays(case)
    r = _radii(inv_r)
    (t_pts, t_metric), (j_pts, j_metric) = _both(o, d, r)
    assert np.all(np.isfinite(t_pts)) and np.all(np.isfinite(t_metric))
    np.testing.assert_allclose(t_pts, j_pts, rtol=1e-6, atol=1e-6)
    # t_metric grows as 1/inv_r (1e6 at the clamp): relative 1e-6.
    np.testing.assert_allclose(t_metric, j_metric, rtol=1e-6, atol=1e-6)
    # The direction part is a unit vector, the last channel inv_r itself.
    np.testing.assert_allclose(np.linalg.norm(t_pts[..., :3], axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(t_pts[..., 3], r)


@pytest.mark.parametrize("inv_r", ["zero_plus", "one", "zero"])
def test_grazing_rays_match_where_the_clamps_bind(inv_r):
    """Rays that touch the sphere: the half chord clamps to 0, and at inv_r
    = 1 the asin clip binds on both of its terms; at inv_r <= 1e-6 the inv_r
    clamp holds t_metric finite."""
    o, d = _rays("touching")
    (t_pts, t_metric), (j_pts, j_metric) = _both(o, d, _radii(inv_r))
    assert np.all(np.isfinite(t_pts)) and np.all(np.isfinite(t_metric))
    np.testing.assert_allclose(t_pts, j_pts, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_metric, j_metric, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["touching", "near"])
@pytest.mark.parametrize("inv_r", ["random", "one"])
def test_grazing_rays_are_as_accurate_as_the_reference(case, inv_r):
    """Where grazing rays are ill-conditioned, both float32 results are held
    against the port's formulas in float64: the port's worst error is at
    most the reference's (plus 1e-6), on points and on t_metric."""
    o, d = _rays(case, seed=1)
    r = _radii(inv_r)
    (t_pts, t_metric), (j_pts, j_metric) = _both(o, d, r)
    (x_pts, x_metric), _ = _both(o, d, r, dtype=torch.float64)
    assert np.all(np.isfinite(t_pts)) and np.all(np.isfinite(t_metric))
    for got, want, exact, name in ((t_pts, j_pts, x_pts, "pts"),
                                   (t_metric, j_metric, x_metric, "t_metric")):
        scale = np.maximum(np.abs(exact), 1.0)
        port_err = np.max(np.abs(got - exact) / scale)
        ref_err = np.max(np.abs(want - exact) / scale)
        assert port_err <= ref_err + 1e-6, (name, port_err, ref_err)
