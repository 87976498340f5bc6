"""The yardstick's arithmetic: percentiles, spreads, interval unions, FLOPs and bounds."""

import statistics

import numpy as np
import pytest

from perfbench import flops, stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy_linear(q):
    xs = np.random.default_rng(3).exponential(size=257)
    assert stats.percentile(list(xs), q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_counts_every_sample():
    xs = [1.0] * 95 + [100.0] * 5
    assert stats.percentile(xs, 95) == pytest.approx(1.0 + 0.05 * 99.0)
    assert stats.percentile(xs, 96) > 1.0


def test_spread_uses_python_quartiles():
    xs = [10.0, 11.0, 12.0, 13.0, 20.0, 9.0]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),  # overlapping kernels count once
    ([(0, 5), (1, 2), (3, 4)], 5.0),  # nested
    ([(3, 4), (0, 1), (0.5, 3.5)], 4.0),  # unsorted
])
def test_union_length(intervals, want):
    assert stats.union_length(intervals) == pytest.approx(want)


def test_gaps_complement_the_union():
    iv = [(1, 2), (1.5, 3), (5, 6)]
    g = stats.gaps(iv, 0, 7)
    assert g == [(0, 1), (3, 5), (6, 7)]
    assert sum(b - a for a, b in g) + stats.union_length(iv) == pytest.approx(7)


def test_linear_flops_counts_multiply_adds():
    assert flops.linear_flops([(3, 4), (4, 2)], 10) == 2 * 10 * (12 + 8)


def test_mip_layers_and_train_flops():
    nerf = flops.cone_mlp_layers({"net_depth": 8, "net_width": 1024}, False)
    assert nerf[0] == (504, 1024)  # 21 basis directions x 12 degrees x sin and cos
    assert nerf[5] == (1024 + 504, 1024)  # the skip after layer 4
    assert nerf[-1] == (128, 3)
    prop = flops.cone_mlp_layers({"net_depth": 4, "net_width": 256}, True)
    assert prop[-1] == (256, 1)
    mp = {"num_prop_samples": 64, "num_nerf_samples": 32, "num_levels": 3,
          "nerf_mlp_params": {"net_depth": 8, "net_width": 1024},
          "prop_mlp_params": {"net_depth": 4, "net_width": 256}}
    per_level = []
    for layers, n in ((prop, 4096 * 64), (prop, 4096 * 64), (nerf, 4096 * 32)):
        per_level.append(3 * flops.linear_flops(layers, n) - flops.linear_flops(layers[:1], n))
    assert flops.mip_train_flops(mp, 4096) == pytest.approx(sum(per_level))
    assert 7.0e12 < flops.mip_train_flops(mp, 4096) < 8.0e12


def test_ngp_flops_cap_at_the_budget():
    mp = {"max_samples": 128, "sample_budget": 32,
          "field_params": {"n_levels": 16, "n_features": 2, "hidden_width": 64}}
    per_point = flops.linear_flops(flops.ngp_field_layers(mp["field_params"]), 1)
    assert flops.ngp_train_flops(mp, 8192, 10.0) == pytest.approx(3 * per_point * 8192 * 10)
    assert flops.ngp_train_flops(mp, 8192, 90.0) == pytest.approx(3 * per_point * 8192 * 32)


def test_kernel_bounds():
    # K1a at [4096, 64]: 12 bytes an element over 3.35 TB/s (bytes bound it).
    for b, ops in ((flops.K1A_BYTES, flops.K1A_OPS), (flops.K1B_BYTES, flops.K1B_OPS),
                   (flops.K2A_BYTES, flops.K2A_OPS)):
        assert b / flops.HBM_BYTES_PER_S > ops / flops.PEAK_FLOPS_PER_S["float32"]
    assert flops.bound_s(4096 * 64, 12, 5) == pytest.approx(4096 * 64 * 12 / 3.35e12)
    mp = {"num_prop_samples": 64, "num_nerf_samples": 32, "num_levels": 3}
    want = sum(flops.bound_s(4096 * s, 12, 5) + flops.bound_s(4096 * s, 16, 4)
               for s in (64, 64, 32))
    assert flops.mip_volren_bound_s(mp, 4096) == pytest.approx(want)
    ngp = {"max_samples": 128, "sample_budget": 32, "field_params": {"n_levels": 16, "n_features": 2}}
    assert flops.ngp_scan_bound_s(ngp, 8192) == pytest.approx(
        16 * flops.bound_s(8192 * 32 * 16, 8, 1))


@pytest.mark.parametrize("name,kind", [
    ("void weights_fwd_kernel<64>(float const*, ...)", "volren_weights"),
    ("prefix_scan_f32_kernel", "prefix_scan"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", "matmul"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather_scatter"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("DeviceRadixSortOnesweepKernel", "sort"),
    ("something_else", "other"),
])
def test_kernel_kind(name, kind):
    assert flops.kernel_kind(name) == kind
