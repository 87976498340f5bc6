"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (the kernels have no CPU mode). Imports neither
JAX nor the TPU package, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import (chunk_gather, cuda_build, hashgrid, hashgrid_grad,
                                         prefix_scan, volren_weights)
from outdoor_nerf_depth_torch.utils import tracing

# Forward: one f32 prefix sum in another order; backward: a suffix sum of
# products on top of it.
FWD_ATOL, BWD_ATOL = 1e-6, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches(kid):
    """The launches of kernel `kid` since the last `cuda_build.reset_launches()`."""
    return cuda_build.launches()[kid]


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
    cuda_build.reset_launches()
    tau_gpu = tau.clone().requires_grad_(True)
    (volren_weights.weights_from_tau(tau_gpu) * g).sum().backward()
    assert (_launches("K1a"), _launches("K1b")) == (1, 1)
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


OCT_SCAN_SHAPE = (4194304, 16)  # the oct layout's one scan: 262,144 points x 16 levels


def test_prefix_scan_at_the_oct_shape(cuda_device):
    """K2a where the oct layout's gradient runs it, once a step, against
    torch.cumsum and a float64 scan, relative to the running |x| sum."""
    x = torch.randn(OCT_SCAN_SHAPE, generator=torch.Generator(device=cuda_device).manual_seed(5),
                    device=cuda_device)
    cuda_build.reset_launches()
    got = prefix_scan.cumsum(x)
    assert _launches("K2a") == 1
    ref = torch.cumsum(x.double().t().contiguous(), dim=1).t()
    scale = torch.cumsum(x.abs().double().t().contiguous(), dim=1).t() + 1.0
    assert float(((got.double() - ref).abs() / scale).max()) < 1e-5
    want = prefix_scan.cumsum_plain(x)
    assert float(((got - want).abs() / scale).max()) < 2e-5


def test_oct_sorted_gradient_matches_its_scatter_gradient(cuda_device):
    """The oct layout at full width (L16, F2, T 2^19) on 262,144 points: one
    K2a launch at [4194304, 16] for the sorted table gradient, which agrees
    with autograd's scatter gradient to 1e-4 of the largest entry (a row is
    the difference of two f32 prefix sums, which reach ~10x the largest
    row; one f32 ulp of a prefix 800x the row is 1e-4 of it)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    kw = dict(n_levels=16, n_features=2, log2_table_size=19, base_resolution=16,
              max_resolution=2048, layout="oct")
    sorted_enc = hashgrid.HashGridEncoding(**kw).to(cuda_device)
    scatter_enc = hashgrid.HashGridEncoding(**kw, grad_mode="scatter").to(cuda_device)
    with torch.no_grad():
        sorted_enc.table.normal_(0.0, 1e-2, generator=gen)
        scatter_enc.table.copy_(sorted_enc.table)
    x = torch.rand((262144, 3), generator=gen, device=cuda_device)
    g = torch.randn((262144, 32), generator=gen, device=cuda_device)
    cuda_build.reset_launches()
    out = sorted_enc(x)
    (out * g).sum().backward()
    assert _launches("K2a") == 1
    out_scatter = scatter_enc(x)
    (out_scatter * g).sum().backward()
    assert _launches("K2a") == 1
    torch.testing.assert_close(out, out_scatter, rtol=0, atol=0)
    want = scatter_enc.table.grad
    atol = 1e-4 * float(want.abs().max())
    assert float((sorted_enc.table.grad - want).abs().max()) <= atol


def test_hashgrid_backward_launches_one_batched_scan(cuda_device):
    gen = torch.Generator().manual_seed(0)
    enc = hashgrid.HashGridEncoding(n_levels=4, n_features=2, log2_table_size=10,
                                    base_resolution=4, max_resolution=64, generator=gen)
    x = torch.rand((4096, 3), generator=gen)
    g = torch.randn((4096, 8), generator=gen)
    enc_gpu = enc.to(cuda_device)
    cuda_build.reset_launches()
    (enc_gpu(x.to(cuda_device)) * g.to(cuda_device)).sum().backward()
    assert (_launches("K2a"), _launches("K2b")) == (0, 1)
    assert (_launches("K3a"), _launches("K3b")) == (1, 1)
    grad_gpu = enc_gpu.table.grad.cpu()
    enc_cpu = hashgrid.HashGridEncoding(n_levels=4, n_features=2, log2_table_size=10,
                                        base_resolution=4, max_resolution=64)
    with torch.no_grad():
        enc_cpu.table.copy_(enc_gpu.table.cpu())
    (enc_cpu(x) * g).sum().backward()
    # Row sums are differences of f32 prefix sums over up to 4096 products
    # of |w g| <= 4: their rounding scales with the prefix, ~1e-3 at most.
    torch.testing.assert_close(grad_gpu, enc_cpu.table.grad, atol=1e-3, rtol=1e-4)


# The osplit table gradient where the NGP train cell runs it once a step:
# 8192 rays x budget 32 = 262,144 points, L16 F2 T 2^19, scale 8
# (resolutions 16 to 32767: 4 dense levels, 12 hashed).
OSPLIT_POINTS, OSPLIT_LOG2_T, OSPLIT_LEVELS = 262144, 19, 16
OSPLIT_RES = tuple(int(r) for r in hashgrid.level_resolutions(OSPLIT_LEVELS, 16, 32768))
# Off the path: few points over a small table (dense, boundary and hashed
# levels), features 1 and 4, P not a multiple of 8.
OSPLIT_CASES = [(OSPLIT_POINTS, OSPLIT_RES, OSPLIT_LOG2_T, 2), (1001, (4, 9, 31), 10, 1),
                (777, (4, 9, 31), 10, 4), (5, (31,), 10, 2)]
# A row's gradient is the difference of two f32 prefix sums of its level,
# which reach ~100x the largest row at the cell's shape: a few f32 ulps of
# them are ~1e-5 of it (2.2e-6 for the CPU's sequential scan at that
# shape); 1e-4 of the largest entry, as the oct layout's test holds.
OSPLIT_RTOL_OF_MAX = 1e-4


def _osplit_inputs(device, points, res, log2_t, n_feats, seed=7):
    """(idx_levels, w_all [P, L, 8], g_lf [P, L, F]) of random points."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((points, 3), generator=gen, device=device)
    g = torch.randn((points, len(res), n_feats), generator=gen, device=device)
    idx_levels, w_all = hashgrid._oct_local_indices_weights(x, res, 2**log2_t)
    return idx_levels, w_all, g


def _osplit_stages(idx_levels, w_all, g, res, table_size):
    """The sort order, products, prefix sums and ends of the one-pass backward."""
    sorted_keys, order = hashgrid._sorted_level_keys(hashgrid._level_keys(idx_levels, table_size))
    vals = hashgrid_grad.sorted_products(order, w_all, g)
    csum = prefix_scan.cumsum_batched(vals)
    return order, vals, csum, hashgrid._level_segment_ends(sorted_keys, len(res), table_size)


@pytest.mark.parametrize("points,res,log2_t,n_feats", OSPLIT_CASES)
def test_osplit_grad_kernels_match_plain_exactly(cuda_device, points, res, log2_t, n_feats):
    """K3a and K3b against their plain versions on the card, on the same
    sort order, prefix sums and ends: bit for bit."""
    table_size = 2**log2_t
    idx_levels, w_all, g = _osplit_inputs(cuda_device, points, res, log2_t, n_feats)
    cuda_build.reset_launches()
    order, vals, csum, ends = _osplit_stages(idx_levels, w_all, g, res, table_size)
    assert _launches("K3a") == 1
    assert torch.equal(vals, hashgrid_grad.sorted_products_plain(order, w_all, g))
    offsets = [hashgrid._oct_offsets(r, table_size) for r in res]
    level_rows = hashgrid._oct_level_rows(res, table_size)
    got = hashgrid_grad.fold_segments(csum, ends, offsets, level_rows, table_size)
    assert _launches("K3b") == 1
    want = hashgrid_grad.fold_segments_plain(csum, ends, offsets, level_rows, table_size)
    assert got.shape == (len(res), table_size, n_feats)
    assert torch.equal(got, want)


@pytest.mark.parametrize("points,res,log2_t,n_feats", OSPLIT_CASES)
def test_osplit_backward_matches_the_per_level_pipeline(cuda_device, points, res, log2_t,
                                                        n_feats):
    """The one-pass table gradient and the per-level pipeline on the card,
    each against float64 sums of the same bf16 products and against each
    other, at OSPLIT_RTOL_OF_MAX of the largest entry."""
    table_size = 2**log2_t
    idx_levels, w_all, g = _osplit_inputs(cuda_device, points, res, log2_t, n_feats, seed=8)
    got = hashgrid._oct_split_table_grad(hashgrid._level_keys(idx_levels, table_size), w_all, g,
                                         res, table_size)
    old = hashgrid._oct_split_table_grad_per_level(idx_levels, w_all, g, res, table_size)
    prod = (w_all[..., None] * g[:, :, None, :]).to(torch.bfloat16).double()
    want = torch.zeros((len(res), table_size, n_feats), dtype=torch.float64, device=cuda_device)
    for level, r in enumerate(res):
        for c, o in enumerate(hashgrid._oct_offsets(r, table_size)):
            want[level].index_add_(0, (idx_levels[level] + o) % table_size, prod[:, level, c])
    atol = OSPLIT_RTOL_OF_MAX * float(want.abs().max())
    for name, grad in (("one pass", got), ("per level", old)):
        err = float((grad.double() - want).abs().max())
        assert err <= atol, (name, err, atol)
    assert float((got - old).abs().max()) <= atol


def test_osplit_backward_launches_and_counts_at_the_cell_shape(cuda_device):
    """One backward at the train cell's shape: 1 K2b, 0 K2a, 1 K3a, 1 K3b,
    and `hashgrid.grad_levels` counts its 16 levels under a profiler (the
    backward runs on autograd's device thread)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.rand((OSPLIT_POINTS, 3), generator=gen, device=cuda_device)
    table = torch.zeros((OSPLIT_LEVELS, 2**OSPLIT_LOG2_T, 2), device=cuda_device,
                        requires_grad=True)
    g = torch.randn((OSPLIT_POINTS, 2 * OSPLIT_LEVELS), generator=gen, device=cuda_device)
    out = hashgrid.OctSplitEncode.apply(x, table, OSPLIT_RES, 2**OSPLIT_LOG2_T)
    cuda_build.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        (out * g).sum().backward()
        torch.cuda.synchronize()
        counters = tracing.snapshot()["counters"]
    assert (_launches("K2a"), _launches("K2b")) == (0, 1)
    assert (_launches("K3a"), _launches("K3b")) == (1, 1)
    assert counters.get("hashgrid.grad_levels") == OSPLIT_LEVELS


def test_osplit_backward_makes_no_host_sync(cuda_device):
    """The backward waits for the card nowhere: no copy of a host constant,
    no read of a device value (torch's sync debug mode raises on either)."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.rand((OSPLIT_POINTS, 3), generator=gen, device=cuda_device)
    table = torch.zeros((OSPLIT_LEVELS, 2**OSPLIT_LOG2_T, 2), device=cuda_device,
                        requires_grad=True)
    g = torch.randn((OSPLIT_POINTS, 2 * OSPLIT_LEVELS), generator=gen, device=cuda_device)
    out = hashgrid.OctSplitEncode.apply(x, table, OSPLIT_RES, 2**OSPLIT_LOG2_T)
    (out * g).sum().backward()  # builds the kernels and warms the allocator
    table.grad = None
    loss = (hashgrid.OctSplitEncode.apply(x, table, OSPLIT_RES, 2**OSPLIT_LOG2_T) * g).sum()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert table.grad is not None and bool(torch.isfinite(table.grad).all())


# K4, the osplit forward, where the NGP cells run it: a train step's 262,144
# points with the table gradient, a view chunk of 16,384 rays x budget 32 =
# 524,288 points and the view's last chunk (60,000 rays: 10,848 x 32 =
# 347,136) without, a refresh chunk of 131,072 (`ops/occupancy.py:
# update_grid`); then the points' gradient, bf16 features, features 1, 4,
# 8 and 16 on small tables, and P not a multiple of 32.
ENCODE_CASES = [  # (points, resolutions, log2 T, F, dtype, keys, rows)
    (OSPLIT_POINTS, OSPLIT_RES, OSPLIT_LOG2_T, 2, torch.float32, True, False),
    (524288, OSPLIT_RES, OSPLIT_LOG2_T, 2, torch.float32, False, False),
    (347136, OSPLIT_RES, OSPLIT_LOG2_T, 2, torch.float32, False, False),
    (131072, OSPLIT_RES, OSPLIT_LOG2_T, 2, torch.float32, False, False),
    (4099, OSPLIT_RES, OSPLIT_LOG2_T, 2, torch.float32, True, True),
    (4099, OSPLIT_RES, OSPLIT_LOG2_T, 2, torch.bfloat16, True, False),
    (1001, (4, 9, 31), 10, 1, torch.float32, True, True),
    (777, (4, 9, 31), 10, 4, torch.bfloat16, True, True),
    (513, (4, 9, 31), 10, 8, torch.float32, True, True),
    (300, (4, 9, 31), 10, 16, torch.bfloat16, True, True),
    (5, (31,), 10, 2, torch.float32, True, True)]


def _encode_inputs(device, points, res, log2_t, n_feats, seed=31):
    """Points in the unit cube and a little outside it, and a table of normal values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 1.1 * torch.rand((points, 3), generator=gen, device=device) - 0.05
    table = torch.randn((len(res), 2**log2_t, n_feats), generator=gen, device=device)
    return x, 1e-2 * table


def _assert_encodes_equal(got, want):
    """K4's outputs against the plain version's: equal bit for bit (None
    alike), NaN where the plain version's are (a NaN's bits may differ)."""
    for name, a, b in zip(("features", "keys", "w_all", "rows"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.is_floating_point():
                nan = b.isnan()
                assert torch.equal(a.isnan(), nan), name
                a, b = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name


@pytest.mark.parametrize("points,res,log2_t,n_feats,dtype,keys,rows", ENCODE_CASES)
def test_osplit_encode_matches_plain_exactly(cuda_device, points, res, log2_t, n_feats, dtype,
                                            keys, rows):
    """K4 against its plain version (the packed bf16 tables of
    `encode_oct_split`) on the card, bit for bit: the features, and the keys,
    weights and corner rows where asked for; one launch."""
    table_size = 2**log2_t
    x, table = _encode_inputs(cuda_device, points, res, log2_t, n_feats)
    cuda_build.reset_launches()
    got = hashgrid._oct_split_forward(x, table, res, table_size, dtype, keys, rows)
    assert _launches("K4") == 1
    want = hashgrid._oct_split_forward_plain(x, table, res, table_size, dtype, keys, rows)
    _assert_encodes_equal(got, want)
    encoded = hashgrid.encode_oct_split(x, table, res, table_size).to(dtype)
    assert torch.equal(got[0], encoded)


def test_osplit_encode_on_faces_bounds_and_the_hash_wrap(cuda_device):
    """Points on cell faces (x res whole), at 0 and 1 and outside, a NaN
    coordinate (its features NaN, as the plain version's clamp keeps it),
    and hashed cells whose corner pairs start at row T - 1 (the pair wraps
    to row 0), bit for bit against the plain version."""
    res, log2_t = OSPLIT_RES, OSPLIT_LOG2_T
    table_size = 2**log2_t
    gen = torch.Generator(device=cuda_device).manual_seed(32)
    faces = [torch.randint(0, r + 1, (4096, 3), generator=gen, device=cuda_device) / r
             for r in res]
    bounds = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [-0.5, 1.5, 1.0],
                           [0.5, float("nan"), 0.25]], device=cuda_device)
    # Hashed cells at the finest level whose base row is T - 1 - offset_c
    # for some pair: search random cells for them.
    r = res[-1]
    cells = torch.randint(0, r, (1 << 22, 3), generator=gen, device=cuda_device)
    base = hashgrid._quad_base_index(cells, r, table_size)
    offsets = hashgrid._oct_offsets(r, table_size)
    wraps = torch.zeros_like(base, dtype=torch.bool)
    for o in offsets[::2]:
        wraps |= (base + o) % table_size == table_size - 1
    assert int(wraps.sum()) > 0
    wrapped = (cells[wraps].to(torch.float32) + 0.5) / r
    x = torch.cat(faces + [bounds, wrapped])
    table = 1e-2 * torch.randn((len(res), table_size, 2), generator=gen, device=cuda_device)
    got = hashgrid._oct_split_forward(x, table, res, table_size, torch.float32, True, True)
    want = hashgrid._oct_split_forward_plain(x, table, res, table_size, torch.float32, True,
                                             True)
    _assert_encodes_equal(got, want)
    nan_row = sum(len(f) for f in faces) + len(bounds) - 1
    assert bool(got[0][nan_row].isnan().all()) and int(got[0].isnan().any(dim=1).sum()) == 1


def test_osplit_encode_writes_what_the_backward_read(cuda_device):
    """The keys and weights K4 writes at the train cell's shape are the
    level-offset keys `_level_keys` builds and the weights of
    `_oct_local_indices_weights`, bit for bit."""
    table_size = 2**OSPLIT_LOG2_T
    x, table = _encode_inputs(cuda_device, OSPLIT_POINTS, OSPLIT_RES, OSPLIT_LOG2_T, 2)
    _, keys, w_all, _ = hashgrid._oct_split_forward(x, table, OSPLIT_RES, table_size,
                                                    torch.float32, True)
    idx_levels, want_w = hashgrid._oct_local_indices_weights(x, OSPLIT_RES, table_size)
    assert torch.equal(keys, hashgrid._level_keys(idx_levels, table_size))
    assert torch.equal(w_all, want_w)


def test_osplit_table_gradient_is_the_plain_paths(cuda_device, monkeypatch):
    """OctSplitEncode's table gradient at the train cell's shape, from K4's
    keys and weights, equals bit for bit the one-pass gradient from the keys
    and weights of the plain index math. The scan K2b sums its carries in a
    timing-dependent order, so both take the plain scan here."""
    monkeypatch.setattr(prefix_scan, "cumsum_batched", prefix_scan.cumsum_batched_plain)
    table_size = 2**OSPLIT_LOG2_T
    x, table = _encode_inputs(cuda_device, OSPLIT_POINTS, OSPLIT_RES, OSPLIT_LOG2_T, 2)
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    g = torch.randn((OSPLIT_POINTS, 2 * OSPLIT_LEVELS), generator=gen, device=cuda_device)
    table.requires_grad_(True)
    cuda_build.reset_launches()
    (hashgrid.OctSplitEncode.apply(x, table, OSPLIT_RES, table_size) * g).sum().backward()
    assert (_launches("K4"), _launches("K3a"), _launches("K3b")) == (1, 1, 1)
    idx_levels, w_all = hashgrid._oct_local_indices_weights(x, OSPLIT_RES, table_size)
    want = hashgrid._oct_split_table_grad(hashgrid._level_keys(idx_levels, table_size), w_all,
                                          g.reshape(OSPLIT_POINTS, OSPLIT_LEVELS, 2), OSPLIT_RES,
                                          table_size)
    assert torch.equal(table.grad, want)


def test_osplit_module_forward_launches_k4_and_makes_no_host_sync(cuda_device):
    """The module's osplit forward on the card: one K4 launch, with and
    without a gradient, no packed table (`prepare` gives None), and no wait
    for the card (torch's sync debug mode raises on one)."""
    gen = torch.Generator().manual_seed(34)
    enc = hashgrid.HashGridEncoding(n_levels=OSPLIT_LEVELS, n_features=2,
                                    log2_table_size=OSPLIT_LOG2_T, base_resolution=16,
                                    max_resolution=32768, generator=gen).to(cuda_device)
    assert enc.resolutions == OSPLIT_RES and enc.prepare() is None
    x = torch.rand((OSPLIT_POINTS, 3), device=cuda_device)
    enc(x).sum().backward()  # builds the kernels and warms the allocator
    with torch.no_grad():
        enc(x)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = enc(x)
        with torch.no_grad():
            plain = enc(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launches("K4") == 2 and plain.grad_fn is None
    assert torch.equal(out.detach(), plain)
    assert torch.equal(plain, hashgrid.encode_oct_split(x, enc.table.detach(), enc.resolutions,
                                                        enc.table_size))


def test_osplit_encode_refuses_what_it_does_not_take(cuda_device):
    """F outside FEATURES and more than MAX_LEVELS levels raise; so does the
    scatter table gradient, which K4 keeps nothing for (its features
    without a gradient are K4's)."""
    x = torch.rand((64, 3), device=cuda_device)
    for shape in [(4, 2**10, 3), (hashgrid_grad.MAX_LEVELS + 1, 2**10, 2)]:
        table = torch.zeros(shape, device=cuda_device)
        res = (4,) * shape[0]
        with pytest.raises(ValueError):
            hashgrid._oct_split_forward(x, table, res, 2**10)
    enc = hashgrid.HashGridEncoding(n_levels=4, n_features=2, log2_table_size=10,
                                    base_resolution=4, max_resolution=64,
                                    grad_mode="scatter").to(cuda_device)
    with pytest.raises(ValueError, match="scatter"):
        enc(x)
    cuda_build.reset_launches()
    with torch.no_grad():
        out = enc(x)
    assert _launches("K4") == 1
    assert torch.equal(out, hashgrid.encode_oct_split(x, enc.table.detach(), enc.resolutions,
                                                      enc.table_size))


# The probe's shape; many tiles per element; many elements of one tile or
# less; lanes 1, 2 (the scalar build), 4 and 128.
@pytest.mark.parametrize("shape", [(16, 524288, 16), (3, 100, 16), (3, 1025, 16), (1, 1, 8),
                                   (2, 7, 128), (5, 4097, 8), (2, 1000003, 16), (4096, 100, 16),
                                   (20000, 7, 8), (3, 70001, 1), (3, 70001, 2), (2, 50001, 4),
                                   (2, 9000, 128)])
def test_batched_prefix_scan_matches_plain(cuda_device, shape):
    x = torch.from_numpy(np.random.RandomState(14).randn(*shape).astype(np.float32)).to(cuda_device)
    cuda_build.reset_launches()
    got = prefix_scan.cumsum_batched(x)
    assert _launches("K2b") == 1 and _launches("K2a") == 0
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("batched", [False, True])
def test_prefix_scan_takes_narrow_floats(cuda_device, dtype, batched):
    """Like the reference, the scans accumulate a bf16 or f16 input in f32
    and return its dtype: the kernel's and the plain version's f32 sums may
    round to neighbouring values, one ulp of the narrow type apart."""
    shape = (3, 70001, 16) if batched else (262144, 16)
    x = torch.from_numpy(np.random.RandomState(23).randn(*shape).astype(np.float32))
    x = x.to(dtype).to(cuda_device)
    cuda_build.reset_launches()
    got = prefix_scan.cumsum_batched(x) if batched else prefix_scan.cumsum(x)
    assert (_launches("K2b"), _launches("K2a")) == ((1, 0) if batched else (0, 1))
    want = (prefix_scan.cumsum_batched_plain if batched else prefix_scan.cumsum_plain)(x)
    assert got.dtype == dtype and got.shape == x.shape
    axis = 1 if batched else 0
    scale = torch.cumsum(x.abs().double(), dim=axis) + 1.0
    ulp = torch.finfo(dtype).eps  # spacing just above 1, relative
    assert float(((got.double() - want.double()).abs() / scale).max()) <= ulp


def test_prefix_scan_empty_input_launches_nothing(cuda_device):
    cuda_build.reset_launches()
    for shape in [(0, 16), (0, 1)]:
        assert prefix_scan.cumsum(torch.empty(shape, device=cuda_device)).shape == shape
    for shape in [(0, 5, 16), (2, 0, 16)]:
        assert prefix_scan.cumsum_batched(torch.empty(shape, device=cuda_device)).shape == shape
    torch.cuda.synchronize()
    assert (_launches("K2a"), _launches("K2b")) == (0, 0)


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
    cuda_build.reset_launches()
    got = chunk_gather.take_from_chunk(idx, table)
    assert _launches("P1") == 1
    assert torch.equal(got, chunk_gather.take_from_chunk_plain(idx, table))


@pytest.mark.parametrize("queries,rows,chunk,tile", [
    (1, 2048, 512, 256), (2049, 2048, 512, 256), (100003, 2048, 512, 256),
    (8388608, 2**19 * 12, 512, 256), (1000, 96, 32, 16), (777, 4096, 1024, 64),
    (100003, 4096, 256, 256), (3001, 480, 48, 32)])
def test_onehot_extract_matches_plain_exactly(cuda_device, queries, rows, chunk, tile):
    idx, table = _gather_inputs(cuda_device, queries, chunk, rows, torch.bfloat16, 16)
    cuda_build.reset_launches()
    got = chunk_gather.onehot_extract(idx, table, chunk, tile)
    assert _launches("P2") == 1
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
    cuda_build.reset_launches()
    got = chunk_gather.onehot_extract(idx, table, 512, 64)
    assert _launches("P2") == 1
    assert torch.equal(got, chunk_gather.onehot_extract_plain(idx, table, 512, 64))
