"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (the kernels have no CPU mode). Imports neither
JAX nor the TPU package, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import chunk_gather, hashgrid, prefix_scan, volren_weights

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


# The path's shapes (NGP's [8192, 128] takes K1a's float4 build, [4096, 64]
# its float2 one), then S off the path: (130, 192) and (3, 300) take the
# float4 build too, (7, 33), (5, 126) and (9, 66) the scalar one.
@pytest.mark.parametrize("shape", [(4096, 64), (4096, 32), (16384, 32), (8192, 128), (7, 33),
                                   (130, 192), (3, 300), (5, 126), (9, 66)])
def test_kernels_match_plain(cuda_device, shape):
    tau, g = _inputs(shape, cuda_device)
    w, e = volren_weights.weights_fwd_cuda(tau)
    w_ref, e_ref = volren_weights.weights_from_tau_plain(tau)
    torch.testing.assert_close(w, w_ref, atol=FWD_ATOL, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=FWD_ATOL, rtol=0)
    dtau = volren_weights.weights_bwd_cuda(g, w, e)
    dtau_ref = volren_weights.weights_from_tau_bwd_plain(g, w_ref, e_ref)
    torch.testing.assert_close(dtau, dtau_ref, atol=BWD_ATOL, rtol=0)


def test_forward_is_finite_with_an_opaque_background(cuda_device):
    """One exp per sample (the transmittance carried along the ray) against
    the plain version's two, with an infinite last tau."""
    tau, _ = _inputs((256, 64), cuda_device, seed=17)
    tau[:, -1] = float("inf")
    w, e = volren_weights.weights_fwd_cuda(tau)
    assert torch.isfinite(w).all() and torch.isfinite(e).all()
    w_ref, e_ref = volren_weights.weights_from_tau_plain(tau)
    torch.testing.assert_close(w, w_ref, atol=FWD_ATOL, rtol=0)
    torch.testing.assert_close(e, e_ref, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(8192, 128), (4096, 64)])
def test_forward_on_a_misaligned_view(cuda_device, shape):
    """A contiguous view 4 bytes off its allocation takes the scalar variant."""
    tau, _ = _inputs(shape, cuda_device, seed=18)
    flat = torch.empty(tau.numel() + 1, device=cuda_device)
    view = flat[1:].view(shape)
    view.copy_(tau)
    assert view.data_ptr() % 8 != 0
    w, e = volren_weights.weights_fwd_cuda(view)
    w_ref, e_ref = volren_weights.weights_fwd_cuda(tau)
    assert torch.equal(w, w_ref) and torch.equal(e, e_ref)


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


@pytest.mark.parametrize("shape", [(262144, 16), (1048576, 16), (1, 8), (7, 8), (4097, 8),
                                   (1, 128), (7, 128), (4097, 128)])
def test_prefix_scan_matches_plain(cuda_device, shape):
    x = torch.from_numpy(np.random.RandomState(13).randn(*shape).astype(np.float32)).to(cuda_device)
    got = prefix_scan.cumsum_cuda(x)
    want = prefix_scan.cumsum_plain(x)
    # Two f32 orders of the same sums: the error of either is a few ulps
    # of the running sum of |x|, so compare relative to it.
    scale = torch.cumsum(x.abs().double(), dim=0) + 1.0
    assert float(((got - want).abs() / scale).max()) < 1e-5


def test_hashgrid_backward_launches_the_scan_once_per_level(cuda_device):
    gen = torch.Generator().manual_seed(0)
    enc = hashgrid.HashGridEncoding(n_levels=4, n_features=2, log2_table_size=10,
                                    base_resolution=4, max_resolution=64, generator=gen)
    x = torch.rand((4096, 3), generator=gen)
    g = torch.randn((4096, 8), generator=gen)
    enc_gpu = enc.to(cuda_device)
    prefix_scan.reset_launch_counts()
    (enc_gpu(x.to(cuda_device)) * g.to(cuda_device)).sum().backward()
    assert prefix_scan.LAUNCHES == 4
    grad_gpu = enc_gpu.table.grad.cpu()
    enc_cpu = hashgrid.HashGridEncoding(n_levels=4, n_features=2, log2_table_size=10,
                                        base_resolution=4, max_resolution=64)
    with torch.no_grad():
        enc_cpu.table.copy_(enc_gpu.table.cpu())
    (enc_cpu(x) * g).sum().backward()
    # Row sums are differences of f32 prefix sums over up to 4096 products
    # of |w g| <= 4: their rounding scales with the prefix, ~1e-3 at most.
    torch.testing.assert_close(grad_gpu, enc_cpu.table.grad, atol=1e-3, rtol=1e-4)


# The probe's shape; many tiles per element; many elements of one tile or
# less; lanes 1, 2 (the scalar build), 4 and 128.
@pytest.mark.parametrize("shape", [(16, 524288, 16), (3, 100, 16), (3, 1025, 16), (1, 1, 8),
                                   (2, 7, 128), (5, 4097, 8), (2, 1000003, 16), (4096, 100, 16),
                                   (20000, 7, 8), (3, 70001, 1), (3, 70001, 2), (2, 50001, 4),
                                   (2, 9000, 128)])
def test_batched_prefix_scan_matches_plain(cuda_device, shape):
    x = torch.from_numpy(np.random.RandomState(14).randn(*shape).astype(np.float32)).to(cuda_device)
    prefix_scan.reset_launch_counts()
    got = prefix_scan.cumsum_batched(x)
    assert prefix_scan.BATCHED_LAUNCHES == 1 and prefix_scan.LAUNCHES == 0
    want = prefix_scan.cumsum_batched_plain(x)
    scale = torch.cumsum(x.abs().double(), dim=1) + 1.0
    assert float(((got - want).abs() / scale).max()) < 1e-5
    # No carry crosses a batch element: each one's row 0 is its input.
    assert torch.equal(got[:, 0], x[:, 0])


def test_batched_prefix_scan_on_a_misaligned_view(cuda_device):
    """A contiguous view 4 bytes off its allocation takes the scalar build."""
    shape = (3, 5001, 16)
    x = torch.from_numpy(np.random.RandomState(21).randn(*shape).astype(np.float32))
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    view = flat[1:].view(shape)
    view.copy_(x.to(cuda_device))
    assert view.data_ptr() % 16 != 0
    got = prefix_scan.cumsum_batched(view)
    scale = torch.cumsum(view.abs().double(), dim=1) + 1.0
    want = prefix_scan.cumsum_batched_plain(view)
    assert float(((got - want).abs() / scale).max()) < 1e-5


@pytest.mark.parametrize("shape", [(16, 524288, 16), (1, 262144, 16)])
def test_batched_prefix_scan_run_to_run(cuda_device, shape):
    """The look-back sums carries in an order that depends on timing: two
    calls on one input may differ, but by no more than the tolerance."""
    x = torch.from_numpy(np.random.RandomState(22).randn(*shape).astype(np.float32)).to(cuda_device)
    first = prefix_scan.cumsum_batched(x)
    second = prefix_scan.cumsum_batched(x)
    scale = torch.cumsum(x.abs().double(), dim=1) + 1.0
    assert float(((first - second).abs() / scale).max()) < 1e-5


def test_prefix_scan_empty_input_launches_nothing(cuda_device):
    prefix_scan.reset_launch_counts()
    for shape in [(0, 16), (0, 1)]:
        assert prefix_scan.cumsum(torch.empty(shape, device=cuda_device)).shape == shape
    for shape in [(0, 5, 16), (2, 0, 16)]:
        assert prefix_scan.cumsum_batched(torch.empty(shape, device=cuda_device)).shape == shape
    torch.cuda.synchronize()
    assert (prefix_scan.LAUNCHES, prefix_scan.BATCHED_LAUNCHES) == (0, 0)


def _gather_inputs(device, queries, high, rows, dtype, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, high, queries).astype(np.int32)
    idx[0], idx[-1] = 0, high - 1
    table = torch.from_numpy(rng.randn(rows, chunk_gather.LANES).astype(np.float32))
    return torch.from_numpy(idx).to(device), table.to(dtype).to(device)


@pytest.mark.parametrize("queries", [1, 2049, 100003, 8388608])
def test_chunk_take_matches_plain_exactly(cuda_device, queries):
    chunk = chunk_gather.TAKE_CHUNK
    idx, table = _gather_inputs(cuda_device, queries, chunk, chunk, torch.float32, 15)
    chunk_gather.reset_launch_counts()
    got = chunk_gather.take_from_chunk(idx, table)
    assert chunk_gather.TAKE_LAUNCHES == 1
    assert torch.equal(got, chunk_gather.take_from_chunk_plain(idx, table))


@pytest.mark.parametrize("queries,rows,chunk,tile", [
    (1, 2048, 512, 256), (2049, 2048, 512, 256), (100003, 2048, 512, 256),
    (8388608, 2**19 * 12, 512, 256), (1000, 96, 32, 16), (777, 4096, 1024, 64),
    (100003, 4096, 256, 256), (3001, 480, 48, 32)])
def test_onehot_extract_matches_plain_exactly(cuda_device, queries, rows, chunk, tile):
    idx, table = _gather_inputs(cuda_device, queries, chunk, rows, torch.bfloat16, 16)
    chunk_gather.reset_launch_counts()
    got = chunk_gather.onehot_extract(idx, table, chunk, tile)
    assert chunk_gather.ONEHOT_LAUNCHES == 1
    # A one-hot product of bf16 values summed in f32 is exact.
    assert torch.equal(got, chunk_gather.onehot_extract_plain(idx, table, chunk, tile))


def test_onehot_extract_out_of_range_rows_are_zero(cuda_device):
    """An index outside [0, chunk) (chunk itself, -1) matches no k-step."""
    chunk, tile, rows = 512, 256, 2048
    idx, table = _gather_inputs(cuda_device, 4099, chunk, rows, torch.bfloat16, 19)
    idx[::7] = chunk
    idx[3::11] = -1
    got = chunk_gather.onehot_extract(idx, table, chunk, tile)
    bad = (idx < 0) | (idx >= chunk)
    assert int(bad.sum()) > 0 and bool((got[bad] == 0).all())
    want = chunk_gather.onehot_extract_plain(idx.clamp(0, chunk - 1), table, chunk, tile)
    assert torch.equal(got[~bad], want[~bad])


def test_onehot_extract_tiles_wrap_over_two_chunks(cuda_device):
    """tile = 64 over a table of 2 chunks: 79 tiles, each chunk read by ~40."""
    idx, table = _gather_inputs(cuda_device, 5003, 512, 1024, torch.bfloat16, 20)
    chunk_gather.reset_launch_counts()
    got = chunk_gather.onehot_extract(idx, table, 512, 64)
    assert chunk_gather.ONEHOT_LAUNCHES == 1
    assert torch.equal(got, chunk_gather.onehot_extract_plain(idx, table, 512, 64))
