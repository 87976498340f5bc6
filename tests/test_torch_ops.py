"""The port's ops (mathx, stepfuns, spaces, volren) against the reference
package on the same numpy inputs, on the CPU.

Unless a test says otherwise the tolerance is atol 1e-6: both sides compute
the same float32 formulas, so only roundoff in a different summation or
evaluation order separates them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import mathx as t_mathx
from outdoor_nerf_depth_torch.ops import spaces as t_spaces
from outdoor_nerf_depth_torch.ops import stepfuns as t_stepfuns
from outdoor_nerf_depth_torch.ops import volren as t_volren
from outdoor_nerf_depth_tpu.ops import mathx as j_mathx
from outdoor_nerf_depth_tpu.ops import spaces as j_spaces
from outdoor_nerf_depth_tpu.ops import stepfuns as j_stepfuns
from outdoor_nerf_depth_tpu.ops import volren as j_volren

# The suite runs files in parallel worker processes: one torch thread per
# worker keeps these small CPU tests from crowding the timing-sensitive
# tests of other workers.
torch.set_num_threads(1)

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    # CPU matmuls in the reference default to bf16-grade passes.
    with jax.default_matmul_precision("highest"):
        yield


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _rng(seed):
    return np.random.RandomState(seed)


def _sorted_edges(shape, seed, lo=0.0, hi=1.0):
    return np.sort(_rng(seed).uniform(lo, hi, shape), axis=-1).astype(np.float32)


def _weights(shape, seed):
    w = _rng(seed).rand(*shape).astype(np.float32) ** 2
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


# -- mathx -------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["safe_sin", "safe_cos"])
def test_safe_trig(fn):
    # Large arguments are folded by a floored modulo in both frameworks; the
    # remainder of a ~1e6 float32 argument is exact to ~0.06, the same on
    # both sides, so sin agrees to float32 roundoff of the reduced argument.
    x = np.concatenate([_rng(0).uniform(-10, 10, 32), [1e3, -2e4, 5e5, 1e6]]).astype(np.float32)
    _close(getattr(t_mathx, fn)(_t(x)), getattr(j_mathx, fn)(jnp.asarray(x)), atol=2e-5)


def test_safe_exp_value_and_gradient_above_clamp():
    x = np.array([-3.0, 0.0, 10.0, 88.0, 100.0], np.float32)
    xt = _t(x).requires_grad_(True)
    y = t_mathx.safe_exp(xt)
    y.sum().backward()
    want_y = j_mathx.safe_exp(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(j_mathx.safe_exp(v)))(jnp.asarray(x))
    _close(y, want_y, rtol=1e-6)
    _close(xt.grad, want_g, rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 512])
def test_lr_schedule(warmup):
    # Host float64 here against float32 in the reference: rtol 1e-6.
    for step in (0, 1, 100, 511, 512, 40000, 75000):
        got = t_mathx.lr_schedule(step, 2e-3, 2e-5, 75000, warmup, 0.01)
        want = j_mathx.lr_schedule(step, 2e-3, 2e-5, 75000, warmup, 0.01)
        np.testing.assert_allclose(got, float(want), rtol=1e-6)


def _knots_with_ties(seed):
    k = _sorted_edges((3, 12), seed)
    k[:, 4:7] = k[:, 4:5]  # a flat stretch, as a CDF over zero weights has
    return k


def test_searchsorted_pair_tie_rule():
    knots = _knots_with_ties(1)
    q = np.concatenate([_rng(2).rand(3, 10), knots[:, [0, 4, 11]], [[-1.0], [2.0], [0.5]]], -1)
    q = q.astype(np.float32)
    got = t_mathx.searchsorted_pair(_t(knots), _t(q))
    want = j_mathx.searchsorted_pair(jnp.asarray(knots), jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sorted_interp():
    xp = _knots_with_ties(3)
    fp = _sorted_edges((3, 12), 4, 0.0, 5.0)
    x = np.sort(np.concatenate([_rng(5).rand(3, 20), xp[:, [0, 5, 11]]], -1), -1).astype(np.float32)
    got = t_mathx.sorted_interp(_t(x), _t(xp), _t(fp))
    _close(got, j_mathx.sorted_interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))


# -- stepfuns ----------------------------------------------------------------


def test_integrate_weights():
    w = _weights((4, 9), 6)
    _close(t_stepfuns.integrate_weights(_t(w)), j_stepfuns.integrate_weights(jnp.asarray(w)))


@pytest.mark.parametrize("deterministic_center", [False, True])
def test_sample_deterministic(deterministic_center):
    t = _sorted_edges((4, 11), 7)
    logits = np.log(_weights((4, 10), 8))
    logits[0, 3:6] = -np.inf  # masked bins, as the model makes
    got = t_stepfuns.sample(None, _t(t), _t(logits), 16, deterministic_center=deterministic_center)
    want = j_stepfuns.sample(None, jnp.asarray(t), jnp.asarray(logits), 16,
                             deterministic_center=deterministic_center)
    # The inverse CDF divides by a bin's CDF width: 1e-5 absorbs its roundoff.
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("single_jitter", [False, True])
def test_sample_jittered_stays_in_range(single_jitter):
    # Jitter comes from a torch.Generator, so only its invariants compare.
    t = _t(_sorted_edges((64, 11), 9))
    logits = _t(np.log(_weights((64, 10), 10)))
    gen = torch.Generator().manual_seed(0)
    s = t_stepfuns.sample(gen, t, logits, 16, single_jitter=single_jitter)
    assert torch.all(s[..., 1:] >= s[..., :-1])
    assert torch.all((s >= t[..., :1]) & (s <= t[..., -1:]))
    again = t_stepfuns.sample(torch.Generator().manual_seed(0), t, logits, 16,
                              single_jitter=single_jitter)
    assert torch.equal(s, again)


def test_sample_intervals_with_domain():
    t = _sorted_edges((4, 11), 11)
    logits = np.log(_weights((4, 10), 12))
    got = t_stepfuns.sample_intervals(None, _t(t), _t(logits), 8, domain=(0.0, 1.0))
    want = j_stepfuns.sample_intervals(None, jnp.asarray(t), jnp.asarray(logits), 8,
                                       domain=(0.0, 1.0))
    _close(got, want, atol=1e-5)  # inverse-CDF roundoff, as above


def test_max_dilate_weights():
    t = _sorted_edges((4, 9), 13)
    w = _weights((4, 8), 14)
    got = t_stepfuns.max_dilate_weights(_t(t), _t(w), 0.03, domain=(0.0, 1.0), renormalize=True)
    want = j_stepfuns.max_dilate_weights(jnp.asarray(t), jnp.asarray(w), 0.03,
                                         domain=(0.0, 1.0), renormalize=True)
    _close(got[0], want[0])
    _close(got[1], want[1], atol=1e-5)  # densities divide by small bin widths


def test_inner_outer_and_envelope_loss():
    t_q, t = _sorted_edges((4, 7), 15), _sorted_edges((4, 11), 16)
    w = _weights((4, 10), 17)
    got = t_stepfuns.inner_outer(_t(t_q), _t(t), _t(w))
    want = j_stepfuns.inner_outer(jnp.asarray(t_q), jnp.asarray(t), jnp.asarray(w))
    _close(got[0], want[0])
    _close(got[1], want[1])
    w_q = _weights((4, 6), 18)
    _close(
        t_stepfuns.outer_envelope_loss(_t(t_q), _t(w_q), _t(t), _t(w)),
        j_stepfuns.outer_envelope_loss(jnp.asarray(t_q), jnp.asarray(w_q), jnp.asarray(t),
                                       jnp.asarray(w)),
        atol=1e-5,  # divides by w + eps
    )


def test_distortion_loss():
    t, w = _sorted_edges((4, 11), 19), _weights((4, 10), 20)
    _close(t_stepfuns.distortion_loss(_t(t), _t(w)),
           j_stepfuns.distortion_loss(jnp.asarray(t), jnp.asarray(w)))


def test_interval_distortion():
    a = _sorted_edges((2, 16), 21)
    b = _sorted_edges((2, 16), 22)
    args = (a[0], a[1], b[0], b[1])
    args = tuple(np.minimum(x, y) for x, y in zip(args[::2], args[1::2])) + tuple(
        np.maximum(x, y) for x, y in zip(args[::2], args[1::2])
    )
    t0_lo, t1_lo, t0_hi, t1_hi = args
    _close(
        t_stepfuns.interval_distortion(_t(t0_lo), _t(t0_hi), _t(t1_lo), _t(t1_hi)),
        j_stepfuns.interval_distortion(*(jnp.asarray(x) for x in (t0_lo, t0_hi, t1_lo, t1_hi))),
        atol=1e-5,  # cubes of edges over a product of widths
    )


def test_weighted_percentile_and_query():
    t, w = _sorted_edges((4, 11), 23), _weights((4, 10), 24)
    _close(t_stepfuns.weighted_percentile(_t(t), _t(w), (5, 50, 95)),
           j_stepfuns.weighted_percentile(jnp.asarray(t), jnp.asarray(w), (5, 50, 95)))
    tq = np.sort(_rng(25).uniform(-0.2, 1.2, (4, 13)), -1).astype(np.float32)
    _close(t_stepfuns.query(_t(tq), _t(t), _t(w)),
           j_stepfuns.query(jnp.asarray(tq), jnp.asarray(t), jnp.asarray(w)))


# -- spaces ------------------------------------------------------------------


def _points_around_unit_sphere(seed):
    d = _rng(seed).randn(24, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = np.concatenate([np.linspace(0.1, 0.9, 8), [0.999, 1.0, 1.001, 1.01], np.linspace(1.5, 50.0, 12)])
    return (d * r[:, None]).astype(np.float32)


def test_contract():
    x = _points_around_unit_sphere(26)
    _close(t_spaces.contract(_t(x)), j_spaces.contract(jnp.asarray(x)))


def test_track_gaussian_through_contraction():
    # Points inside, on and outside the unit sphere; full covariances.
    x = _points_around_unit_sphere(27)
    a = _rng(28).randn(x.shape[0], 3, 3).astype(np.float32) * 0.1
    cov = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    got = t_spaces.track_gaussian(t_spaces.contract, _t(x), _t(cov))
    want = j_spaces.track_gaussian(j_spaces.contract, jnp.asarray(x), jnp.asarray(cov))
    _close(got[0], want[0])
    _close(got[1], want[1], atol=1e-6, rtol=1e-5)  # J cov J^T: two products


@pytest.mark.parametrize("warp", [None, "reciprocal", "log", "piecewise"])
def test_metric_to_normalized(warp):
    near = np.full((5, 1), 0.2, np.float32)
    far = np.full((5, 1), 100.0, np.float32)
    s = _sorted_edges((5, 9), 29)
    t_to_s, s_to_t = t_spaces.metric_to_normalized(warp, _t(near), _t(far))
    j_t_to_s, j_s_to_t = j_spaces.metric_to_normalized(warp, jnp.asarray(near), jnp.asarray(far))
    t = s_to_t(_t(s))
    _close(t, j_s_to_t(jnp.asarray(s)), rtol=1e-6)
    _close(t_to_s(t), j_t_to_s(jnp.asarray(t.numpy())), atol=1e-5)


def test_integrated_and_plain_pos_enc():
    mean = _rng(30).randn(6, 21).astype(np.float32)
    var = _rng(31).rand(6, 21).astype(np.float32)
    _close(t_spaces.integrated_pos_enc(_t(mean), _t(var), 0, 5),
           j_spaces.integrated_pos_enc(jnp.asarray(mean), jnp.asarray(var), 0, 5), atol=2e-6)
    d = _rng(32).randn(6, 3).astype(np.float32)
    _close(t_spaces.pos_enc(_t(d), 0, 4), j_spaces.pos_enc(jnp.asarray(d), 0, 4), atol=2e-6)


@pytest.mark.parametrize("base_shape,subdivisions", [("icosahedron", 2), ("octahedron", 3)])
def test_sphere_basis_and_projection(base_shape, subdivisions):
    basis = t_spaces.sphere_basis(base_shape, subdivisions)
    _close(basis, j_spaces.sphere_basis(base_shape, subdivisions))
    mean = _rng(33).randn(8, 3).astype(np.float32)
    a = _rng(34).randn(8, 3, 3).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    got = t_spaces.project_and_diagonalize(_t(mean), _t(cov), basis)
    want = j_spaces.project_and_diagonalize(jnp.asarray(mean), jnp.asarray(cov),
                                            jnp.asarray(basis.numpy()))
    _close(got[0], want[0], atol=1e-5)
    _close(got[1], want[1], atol=1e-5)


# -- volren ------------------------------------------------------------------


@pytest.mark.parametrize("diagonal", [False, True])
def test_cast_rays(diagonal):
    tdist = _sorted_edges((5, 9), 35, 0.5, 20.0)
    origins = _rng(36).randn(5, 3).astype(np.float32)
    dirs = _rng(37).randn(5, 3).astype(np.float32)
    radii = _rng(38).uniform(1e-3, 1e-2, (5, 1)).astype(np.float32)
    got = t_volren.cast_rays(_t(tdist), _t(origins), _t(dirs), _t(radii), diagonal=diagonal)
    want = j_volren.cast_rays(jnp.asarray(tdist), jnp.asarray(origins), jnp.asarray(dirs),
                              jnp.asarray(radii), diagonal=diagonal)
    _close(got[0], want[0], rtol=1e-6, atol=1e-5)
    _close(got[1], want[1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("opaque_background", [False, True])
def test_composite_weights(opaque_background):
    density = _rng(39).rand(6, 16).astype(np.float32) * 3
    tdist = _sorted_edges((6, 17), 40, 0.5, 5.0)
    dirs = _rng(41).randn(6, 3).astype(np.float32)
    got = t_volren.composite_weights(_t(density), _t(tdist), _t(dirs), opaque_background)
    want = j_volren.composite_weights(jnp.asarray(density), jnp.asarray(tdist), jnp.asarray(dirs),
                                      opaque_background, use_pallas=False)
    _close(got, want)


def test_composite_with_extras():
    n, s = 6, 16
    weights = _weights((n, s), 42) * 0.9
    rgbs = _rng(43).rand(n, s, 3).astype(np.float32)
    tdist = _sorted_edges((n, s + 1), 44, 0.5, 50.0)
    t_far = np.full((n, 1), 60.0, np.float32)
    got = t_volren.composite(_t(rgbs), _t(weights), _t(tdist), 1.0, _t(t_far), True)
    want = j_volren.composite(jnp.asarray(rgbs), jnp.asarray(weights), jnp.asarray(tdist), 1.0,
                              jnp.asarray(t_far), True)
    assert set(got) == set(want)
    for key in want:
        # Distances are up to 60: relative 1e-6 of them.
        _close(got[key], want[key], atol=1e-6, rtol=1e-6)
