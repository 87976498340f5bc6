"""The port's hash-grid encoding ("osplit" layout), spherical harmonics and
truncated exp against the reference package on the CPU, with the same
numpy inputs: L=4 levels (one dense, three hashed), T=2^10, F=2, 256 points.
The reference's sorted-segment gradient (`_oct_split_grad_encode`) is the
reference for the table gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import hashgrid as t_hg
from outdoor_nerf_depth_torch.ops import hashgrid_grad
from outdoor_nerf_depth_torch.utils import tracing
from outdoor_nerf_depth_tpu.ops import hashgrid as j_hg

torch.set_num_threads(1)

L, LOG2_T, F, N = 4, 10, 2, 256
T = 2**LOG2_T
RES = tuple(int(r) for r in j_hg.level_resolutions(L, 4, 64))


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.05, 1.05, (N, 3)).astype(np.float32)  # some outside the clip
    table = rng.normal(0.0, 0.1, (L, T, F)).astype(np.float32)
    g = rng.normal(size=(N, L * F)).astype(np.float32)
    return x, table, g


def test_levels_cover_dense_and_hashed():
    assert RES == tuple(int(r) for r in t_hg.level_resolutions(L, 4, 64))
    assert t_hg.growth_factor(L, 4, 64) == j_hg.growth_factor(L, 4, 64)
    dense = [(r + 1) ** 3 <= T for r in RES]
    assert dense[0] and not dense[-1]
    assert t_hg._oct_level_rows(RES, T) == j_hg._oct_level_rows(RES, T)
    for r in RES:
        assert t_hg._oct_offsets(r, T) == j_hg._oct_offsets(r, T)


@pytest.mark.parametrize("res,log2_t", [(32, 10), (5, 10), (32768, 19), (2048, 19)])
def test_base_index_matches_exactly(res, log2_t):
    """int64 arithmetic masked by T-1 equals the reference's wrapping uint32
    hash, up to the largest cell of the KITTI NGP config (res 32768)."""
    rng = np.random.default_rng(res)
    cell = rng.integers(0, res, (4096, 3)).astype(np.int32)
    cell[0] = res - 1
    want, _ = j_hg._quad_base_index(jnp.asarray(cell), res, 2**log2_t)
    got = t_hg._quad_base_index(torch.from_numpy(cell).to(torch.int64), res, 2**log2_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_indices_and_weights(inputs):
    x, *_ = inputs
    j_idx, j_w = j_hg._oct_local_indices_weights(jnp.asarray(x), np.asarray(RES), T)
    t_idx, t_w = t_hg._oct_local_indices_weights(torch.from_numpy(x), RES, T)
    for a, b in zip(t_idx, j_idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Products of three f32 factors: a few ulps.
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-6, atol=1e-7)


def test_bf16_tables_bitwise(inputs):
    _, table, _ = inputs
    want = j_hg.build_oct_tables_split(jnp.asarray(table), np.asarray(RES), T)
    got = t_hg.build_oct_tables_split(torch.from_numpy(table), RES, T)
    assert len(got) == L
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        # Both round f32 to nearest even: identical bits.
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))


def test_encode_oct_split(inputs):
    x, table, _ = inputs
    want = j_hg.encode_oct_split(jnp.asarray(x), jnp.asarray(table), np.asarray(RES), T)
    got = t_hg.encode_oct_split(torch.from_numpy(x), torch.from_numpy(table), RES, T)
    # The same bf16 rows blended in f32 with ulp-close weights.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    enc = t_hg.HashGridEncoding(n_levels=L, n_features=F, log2_table_size=LOG2_T,
                                base_resolution=4, max_resolution=64)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
        np.testing.assert_array_equal(enc(torch.from_numpy(x), prepared=enc.prepare()).numpy(),
                                      got.numpy())


def test_table_and_point_gradients_match_sorted_reference(inputs):
    """A linear loss sum(out * g) hands both the same cotangent bit for bit,
    so the bf16-rounded products w*g agree and only the scan order differs.

    A table row's gradient is the difference of two f32 prefix sums over up
    to N rows of products |w g| <= 4, so its rounding error scales with the
    prefix (N * 4 * 2^-24 ~ 6e-5), not with the row: atol 1e-4 covers two
    orders of the sum. Point gradients blend the same bf16 rows: 1e-5.
    """
    x, table, g = inputs
    fn = j_hg._oct_split_grad_encode(RES, T)
    j_dx, j_dt = jax.grad(lambda a, b: jnp.sum(fn(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    out = t_hg.OctSplitEncode.apply(xt, tt, RES, T)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(fn(jnp.asarray(x), jnp.asarray(table))),
                               rtol=1e-5, atol=1e-7)
    (out * torch.from_numpy(g)).sum().backward()
    assert float(np.abs(np.asarray(j_dt)).sum()) > 1.0
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(j_dt), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), rtol=1e-4, atol=1e-5)


def test_row_sums_against_numpy():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 50, 300)
    vals = rng.normal(size=(300, 16)).astype(np.float32)
    got = t_hg._oct_split_row_sums(torch.from_numpy(idx), torch.from_numpy(vals), 60)
    bf = torch.from_numpy(vals).to(torch.bfloat16).to(torch.float32).numpy()
    want = np.zeros((60, 16))
    np.add.at(want, idx, bf)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.all(got[50:].numpy() == 0)


def test_spherical_harmonics(inputs):
    d = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(t_hg.spherical_harmonics(torch.from_numpy(d)).numpy(),
                               np.asarray(j_hg.spherical_harmonics(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-6)


def test_truncated_exp_forward_and_gradient():
    x = np.array([-20.0, -15.0, -1.0, 0.0, 2.5, 15.0, 16.0, 40.0], np.float32)
    j_y, j_vjp = jax.vjp(j_hg.truncated_exp, jnp.asarray(x))
    (j_g,) = j_vjp(jnp.ones_like(j_y))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_hg.truncated_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y), rtol=1e-6)
    # The gradient stays g exp(clip(x)) outside the clip, not 0.
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_g), rtol=1e-6)
    assert xt.grad[-1] > 0 and xt.grad[0] > 0


def test_encoding_module_options():
    gen = torch.Generator().manual_seed(0)
    enc = t_hg.HashGridEncoding(n_levels=L, n_features=F, log2_table_size=LOG2_T,
                                base_resolution=4, max_resolution=64, generator=gen)
    assert enc.table.shape == (L, T, F) and enc.resolutions == RES
    assert enc.table.abs().max() <= 1e-4 and enc.out_dim == L * F
    # Every layout and gradient mode builds (tests/test_torch_ngp_layouts.py
    # holds them against the reference); unknown values and a pack on the
    # osplit layout raise.
    for layout in ("oct", "quad", "corner"):
        assert t_hg.HashGridEncoding(n_levels=L, log2_table_size=LOG2_T,
                                     layout=layout).layout == layout
    assert not t_hg.HashGridEncoding(n_levels=L, log2_table_size=LOG2_T,
                                     grad_mode="scatter").sorted_grad
    with pytest.raises(ValueError):
        t_hg.HashGridEncoding(layout="nope")
    with pytest.raises(ValueError):
        t_hg.HashGridEncoding(pack_rows=64)
    with pytest.raises(ValueError):
        t_hg.HashGridEncoding(grad_mode="nope")


# The NGP cells' grid (L16, F2, base 16, finest 32768, T 2^19) scaled down:
# 16 levels from 4 to 512 over T = 2^12, so levels up to res 15 are dense
# and the rest hashed.
NGP_L, NGP_LOG2_T = 16, 12
NGP_RES = tuple(int(r) for r in t_hg.level_resolutions(NGP_L, 4, 512))


def _ngp_inputs(n=300, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    table = rng.normal(0.0, 0.1, (NGP_L, 2**NGP_LOG2_T, F)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatcher_plain_twin_equals_encode_oct_split(dtype):
    """K4's dispatcher on the CPU (its plain twin) gives encode_oct_split's
    features bit for bit, in the compute dtype, with the keys, weights and
    rows the backward reads, at dense and hashed levels."""
    x, table = _ngp_inputs()
    T_ngp = 2**NGP_LOG2_T
    dense = [t_hg._is_dense(r, T_ngp) for r in NGP_RES]
    assert any(dense) and not all(dense)
    out, keys, w_all, rows = t_hg._oct_split_forward(x, table, NGP_RES, T_ngp, dtype,
                                                     keys=True, rows=True)
    want = t_hg.encode_oct_split(x, table, NGP_RES, T_ngp).to(dtype)
    assert out.dtype == dtype and torch.equal(out, want)
    idx_levels, want_w = t_hg._oct_local_indices_weights(x, NGP_RES, T_ngp)
    assert keys.dtype == torch.int32 and torch.equal(keys, t_hg._level_keys(idx_levels, T_ngp))
    assert torch.equal(w_all, want_w)
    phys = t_hg.build_oct_tables_split(table, NGP_RES, T_ngp)
    assert rows.dtype == torch.bfloat16 and rows.shape == (len(x), NGP_L, 8 * F)
    for level, idx in enumerate(idx_levels):
        assert torch.equal(rows[:, level], phys[level][idx])
    assert t_hg._oct_split_forward(x, table, NGP_RES, T_ngp)[1:] == (None, None, None)


def test_saved_keys_and_weights_give_the_one_pass_gradient():
    """OctSplitEncode's table gradient, from the keys and weights its forward
    keeps, equals the one pass run on the plain index math's, bit for bit;
    its point gradient equals the analytic one from the kept rows."""
    x, table = _ngp_inputs(seed=5)
    T_ngp = 2**NGP_LOG2_T
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(len(x), NGP_L * F))
                         .astype(np.float32))
    xt, tt = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    (t_hg.OctSplitEncode.apply(xt, tt, NGP_RES, T_ngp) * g).sum().backward()
    idx_levels, w_all = t_hg._oct_local_indices_weights(x, NGP_RES, T_ngp)
    g_lf = g.reshape(len(x), NGP_L, F)
    want = t_hg._oct_split_table_grad(t_hg._level_keys(idx_levels, T_ngp), w_all, g_lf, NGP_RES,
                                      T_ngp)
    assert torch.equal(tt.grad, want)
    rows = t_hg._oct_split_gather(x, table, NGP_RES, T_ngp)[2]
    want_dx = t_hg._trilinear_dx(x, NGP_RES, t_hg._corner_sums(g_lf, t_hg._level_feats(rows, F)))
    assert torch.equal(xt.grad, want_dx)


def test_forward_keeps_only_what_the_backward_reads(monkeypatch):
    """The module's osplit forward asks the dispatcher for the keys and
    weights only where the table takes a gradient, for the rows only where
    the points do, and for neither under no_grad, where no graph is kept."""
    asked = []
    dispatch = t_hg._oct_split_forward

    def recording(*args, keys=False, rows=False):
        asked.append((keys, rows))
        return dispatch(*args, keys=keys, rows=rows)

    monkeypatch.setattr(t_hg, "_oct_split_forward", recording)
    enc = t_hg.HashGridEncoding(n_levels=L, n_features=F, log2_table_size=LOG2_T,
                                base_resolution=4, max_resolution=64)
    x, _ = _ngp_inputs(n=64)
    with torch.no_grad():
        assert enc(x).grad_fn is None
    assert enc(x).grad_fn is not None
    assert enc(x.clone().requires_grad_(True)).grad_fn is not None
    enc.table.requires_grad_(False)
    assert enc(x).grad_fn is None
    assert asked == [(False, False), (True, False), (True, True), (False, False)]


def test_forward_counts_its_levels_under_the_profiler():
    """`hashgrid.fwd_levels`: the levels one osplit forward encodes in one
    pass, 16 a forward at the NGP cells' 16 levels, with and without a
    gradient."""
    enc = t_hg.HashGridEncoding(n_levels=NGP_L, n_features=F, log2_table_size=NGP_LOG2_T,
                                base_resolution=4, max_resolution=512)
    x, _ = _ngp_inputs(n=64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        enc(x).sum().backward()
        with torch.no_grad():
            enc(x)
        counters = tracing.snapshot()["counters"]
    assert counters["hashgrid.fwd_levels"] == 2 * NGP_L


def test_cuda_dispatcher_refuses_unsupported_shapes():
    """K4 takes F in FEATURES and at most MAX_LEVELS levels; the CUDA
    entry raises on any other before it touches a card."""
    x = torch.rand((8, 3))
    for shape in [(2, 2**10, 3), (hashgrid_grad.MAX_LEVELS + 1, 2**10, 2)]:
        n_levels = shape[0]
        with pytest.raises(ValueError, match="features|levels"):
            hashgrid_grad.oct_split_encode_cuda(x, torch.zeros(shape), (4,) * n_levels,
                                                (5,) * n_levels, (0, 5, 25, 30) * n_levels)
