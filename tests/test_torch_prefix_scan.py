"""The port's prefix scan (K2a's plain path on the CPU) against the reference
package's Pallas scan run in interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import prefix_scan
from outdoor_nerf_depth_tpu.ops import pallas_scan

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [7, 512, 4096, 4097, 12345])
@pytest.mark.parametrize("lanes", [16, 8, 128])
def test_matches_pallas_interpret(n, lanes):
    rng = np.random.default_rng(n + lanes)
    x = rng.normal(size=(n, lanes)).astype(np.float32)
    want = np.asarray(pallas_scan.cumsum(jnp.asarray(x), block_rows=64, interpret=True))
    got = prefix_scan.cumsum(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n, lanes)
    # Two f32 orders of the same sums: random walks of up to 12345 steps
    # drift by ~1e-4 (the reference's own tolerance for its blocked scan).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_ones_count_exactly():
    got = prefix_scan.cumsum(torch.ones((4097, 16)))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.arange(1, 4098, dtype=np.float32))


def test_bfloat16_accumulates_in_float32():
    x = torch.full((1000, 8), 1.0, dtype=torch.bfloat16)
    got = prefix_scan.cumsum(x)
    # bf16 accumulation would stall at 256; f32 accumulation reaches 1000.
    assert got.dtype == torch.bfloat16 and float(got[-1, 0]) == 1000.0


@pytest.mark.parametrize("shape", [(8, 48), (8, 0), (8,), (2, 4, 16)])
def test_bad_shapes_raise(shape):
    with pytest.raises(ValueError):
        prefix_scan.cumsum(torch.ones(shape))


def test_cpu_uses_the_plain_version_and_counts_no_launch():
    prefix_scan.reset_launch_counts()
    prefix_scan.cumsum(torch.ones((10, 16)))
    assert prefix_scan.LAUNCHES == 0
    with pytest.raises(ValueError, match="no prefix-scan implementation"):
        prefix_scan.cumsum(torch.ones((10, 16), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        prefix_scan.cumsum_cuda(torch.ones((10, 16)))


# The plain CPU path against the Pallas scan, at small sizes shaped like the
# card tests' cases (many batch elements of a few rows, rows over several
# 16384-element tiles, lanes 1); the kernel's own tiling is held against the
# plain version by the card tests in tests/test_torch_cuda_kernels.py.
@pytest.mark.parametrize("shape", [(3, 100, 16), (3, 1025, 16), (2, 700, 8), (2, 300, 128),
                                   (64, 7, 16), (2, 9000, 16), (3, 5000, 1)])
def test_batched_matches_pallas_interpret(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(pallas_scan.cumsum_batched(jnp.asarray(x), block_rows=32, interpret=True))
    got = prefix_scan.cumsum_batched(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    # The reference's own tolerance for its blocked scan (see above).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    # No carry crosses a batch element: each one's row 0 is its input.
    np.testing.assert_array_equal(got[:, 0].numpy(), x[:, 0])


@pytest.mark.parametrize("shape,match", [((2, 8, 48), "divide"), ((2, 8, 0), "divide"),
                                         ((8, 16), "3-D"), ((2, 2, 8, 16), "3-D")])
def test_batched_bad_shapes_raise(shape, match):
    with pytest.raises(ValueError, match=match):
        prefix_scan.cumsum_batched(torch.ones(shape))


def test_batched_cpu_uses_the_plain_version_and_counts_no_launch():
    prefix_scan.reset_launch_counts()
    x = torch.ones((2, 10, 16), dtype=torch.bfloat16)
    got = prefix_scan.cumsum_batched(x)
    assert got.dtype == torch.bfloat16 and float(got[1, -1, 0]) == 10.0
    assert (prefix_scan.LAUNCHES, prefix_scan.BATCHED_LAUNCHES) == (0, 0)
    with pytest.raises(ValueError, match="no prefix-scan implementation"):
        prefix_scan.cumsum_batched(torch.ones((2, 10, 16), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        prefix_scan.cumsum_batched_cuda(torch.ones((2, 10, 16)))


@pytest.mark.parametrize("op,shape", [(prefix_scan.cumsum, (0, 16)),
                                      (prefix_scan.cumsum_batched, (0, 5, 16)),
                                      (prefix_scan.cumsum_batched, (2, 0, 16))])
def test_empty_input_is_empty_and_counts_no_launch(op, shape):
    prefix_scan.reset_launch_counts()
    assert op(torch.ones(shape)).shape == shape
    assert (prefix_scan.LAUNCHES, prefix_scan.BATCHED_LAUNCHES) == (0, 0)


@pytest.mark.parametrize("batch,rows,lanes,want", [
    # the osplit probe: 16 levels x 524288 points x 16 lanes, 1024-row tiles
    (16, 524288, 16, (512, 16 * 512 * 16 + 1)),
    # K2a's path and the probe's per-level scan, run as B = 1
    (1, 262144, 16, (256, 256 * 16 + 1)),
    (1, 524288, 16, (512, 512 * 16 + 1)),
    # one tile per element; lanes 1 (16384-row tiles) and 128 (128-row tiles),
    # ragged last tiles
    (4096, 100, 16, (1, 4096 * 16 + 1)),
    (3, 70001, 1, (5, 3 * 5 + 1)),
    (2, 9000, 128, (71, 2 * 71 * 128 + 1)),
])
def test_tile_plan(batch, rows, lanes, want):
    assert prefix_scan.tile_plan(batch, rows, lanes) == want
