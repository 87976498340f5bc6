"""Compositing weights (K1): the port's plain versions and autograd Function
against the Pallas kernel (interpreter mode) and its jnp ground truth.

On the CPU the Function runs the plain PyTorch versions; the CUDA kernels
themselves are held against the same plain versions on the card
(`tests/test_torch_cuda_kernels.py`, which skips without one, and
`chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import cuda_build, volren_weights
from outdoor_nerf_depth_tpu.ops import pallas_volren

# The suite runs files in parallel worker processes: one torch thread per
# worker keeps these small CPU tests from crowding the timing-sensitive
# tests of other workers.
torch.set_num_threads(1)

# Forward: both sides are one f32 exclusive cumsum and two exps per sample;
# only the summation order of the prefix differs (1e-6, as the Pallas tests).
FWD_ATOL = 1e-6
# Gradient: a suffix sum of products on top of the forward's rounding.
BWD_ATOL = 1e-5


def _random_tau(shape, seed=0, scale=2.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


def _torch_w(tau_np):
    return volren_weights.weights_from_tau(torch.from_numpy(tau_np)).numpy()


@pytest.mark.parametrize("shape", [(4, 32), (130, 192), (3, 5, 64), (7, 33)])
def test_forward_matches_pallas_and_reference(shape):
    tau = _random_tau(shape)
    got = _torch_w(tau)
    assert got.shape == tau.shape
    pallas = np.asarray(pallas_volren.weights_from_tau(jnp.asarray(tau), True))
    ref = np.asarray(pallas_volren.weights_from_tau_reference(jnp.asarray(tau)))
    np.testing.assert_allclose(got, pallas, atol=FWD_ATOL)
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)


def test_plain_residual_is_next_transmittance():
    tau = torch.from_numpy(_random_tau((5, 40), seed=9))
    w, e = volren_weights.weights_from_tau_plain(tau)
    trans = torch.exp(-torch.cumsum(tau, dim=-1))  # T_{i+1}
    np.testing.assert_allclose(e.numpy(), trans.numpy(), atol=FWD_ATOL)
    np.testing.assert_allclose((w.sum(-1) + e[:, -1]).numpy(), np.ones(5), atol=1e-5)


@pytest.mark.parametrize("shape", [(6, 40), (7, 33), (3, 5, 64)])
def test_gradient_matches_pallas(shape):
    tau = _random_tau(shape, seed=2)
    coefs = np.random.RandomState(3).randn(*shape).astype(np.float32)
    g_want = jax.grad(
        lambda t: jnp.sum(jnp.asarray(coefs) * pallas_volren.weights_from_tau(t, True))
    )(jnp.asarray(tau))
    tau_t = torch.from_numpy(tau).requires_grad_(True)
    (torch.from_numpy(coefs) * volren_weights.weights_from_tau(tau_t)).sum().backward()
    np.testing.assert_allclose(tau_t.grad.numpy(), np.asarray(g_want), atol=BWD_ATOL)


def test_gradient_early_termination_region():
    # Samples behind an opaque wall get ~zero weight and ~zero gradient.
    tau = np.concatenate([np.full((2, 4), 10.0, np.float32), _random_tau((2, 28), seed=4)], -1)
    tau_t = torch.from_numpy(tau).requires_grad_(True)
    (volren_weights.weights_from_tau(tau_t) ** 2).sum().backward()
    g = tau_t.grad.numpy()
    assert np.all(np.isfinite(g))
    assert np.all(np.abs(g[:, 8:]) < 1e-8)
    g_want = jax.grad(
        lambda t: jnp.sum(pallas_volren.weights_from_tau(t, True) ** 2)
    )(jnp.asarray(tau))
    np.testing.assert_allclose(g, np.asarray(g_want), atol=BWD_ATOL)


def test_infinite_last_tau_is_clamped():
    # An opaque background makes the last optical depth +inf.
    tau = _random_tau((4, 16), seed=6)
    tau[:, -1] = np.inf
    got = _torch_w(tau)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got.sum(-1), np.ones(4), atol=1e-6)
    want = np.asarray(pallas_volren.weights_from_tau(jnp.asarray(tau), True))
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    tau_t = torch.from_numpy(tau).requires_grad_(True)
    volren_weights.weights_from_tau(tau_t).sum().backward()
    g_want = jax.grad(lambda t: jnp.sum(pallas_volren.weights_from_tau(t, True)))(
        jnp.asarray(tau)
    )
    np.testing.assert_allclose(tau_t.grad.numpy(), np.asarray(g_want), atol=BWD_ATOL)


def test_cpu_path_launches_no_kernel():
    cuda_build.reset_launches()
    tau = torch.from_numpy(_random_tau((3, 8))).requires_grad_(True)
    volren_weights.weights_from_tau(tau).sum().backward()
    assert (cuda_build.launches()["K1a"], cuda_build.launches()["K1b"]) == (0, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    # No fallback inside the kernel wrappers: only the Function picks the
    # plain version, and only for CPU tensors.
    tau = torch.from_numpy(_random_tau((4, 8)))
    with pytest.raises(ValueError):
        volren_weights.weights_fwd_cuda(tau)
    with pytest.raises(ValueError):
        volren_weights.weights_bwd_cuda(tau, tau, tau)
