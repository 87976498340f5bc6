"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (the kernels have no CPU mode). Imports neither
JAX nor the TPU package, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import volren_weights

# Forward: one f32 prefix sum in another order; backward: a suffix sum of
# products on top of it.
FWD_ATOL, BWD_ATOL = 1e-6, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device, seed=11):
    rng = np.random.RandomState(seed)
    tau = torch.from_numpy((rng.rand(*shape) * 2).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
    return tau, g


@pytest.mark.parametrize("shape", [(4096, 64), (4096, 32), (16384, 32), (7, 33), (130, 192), (3, 300)])
def test_kernels_match_plain(cuda_device, shape):
    tau, g = _inputs(shape, cuda_device)
    w, e = volren_weights.weights_fwd_cuda(tau)
    w_ref, e_ref = volren_weights.weights_from_tau_plain(tau)
    torch.testing.assert_close(w, w_ref, atol=FWD_ATOL, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=FWD_ATOL, rtol=0)
    dtau = volren_weights.weights_bwd_cuda(g, w, e)
    dtau_ref = volren_weights.weights_from_tau_bwd_plain(g, w_ref, e_ref)
    torch.testing.assert_close(dtau, dtau_ref, atol=BWD_ATOL, rtol=0)


def test_function_launches_kernels_and_matches_cpu(cuda_device):
    tau, g = _inputs((3, 5, 64), cuda_device, seed=12)
    tau[..., -1] = float("inf")  # opaque background
    volren_weights.reset_launch_counts()
    tau_gpu = tau.clone().requires_grad_(True)
    (volren_weights.weights_from_tau(tau_gpu) * g).sum().backward()
    assert (volren_weights.FWD_LAUNCHES, volren_weights.BWD_LAUNCHES) == (1, 1)
    tau_cpu = tau.cpu().requires_grad_(True)
    w_cpu = volren_weights.weights_from_tau(tau_cpu)
    (w_cpu * g.cpu()).sum().backward()
    torch.testing.assert_close(volren_weights.weights_from_tau(tau).cpu(), w_cpu.detach(),
                               atol=FWD_ATOL, rtol=0)
    torch.testing.assert_close(tau_gpu.grad.cpu(), tau_cpu.grad, atol=BWD_ATOL, rtol=0)
