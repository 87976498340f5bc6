"""The port's oct, quad and corner hash layouts, `pack_rows`, the sorted and
scatter table gradients, the osplit backward (which reads none of the
reference's environment switches) and one train step per layout, against the reference package on the CPU with the
same numpy inputs. Three levels at T = 2^10: dense (res 4), dense at the
boundary ((9 + 1)^3 = 1000 <= 1024, where the trimmed oct table's roll fold
must stay exact) and hashed (res 31), as the reference's own
`test_oct_trimmed_dense_boundary_level` has them; some points lie outside
the unit cube, where the clip holds them.

Tolerances: forwards at 1e-6 (the same rows blended with weights a few
ulps apart). Table gradients at 1e-6 of the largest entry between the
scatter modes (accumulating gathers in both packages); at 2e-6 wherever a
sorted gradient takes part, against the reference's sorted VJPs, the f32
scatter or float64 sums of the same products: a sorted row's sum is the
difference of two prefix sums stored in f32, so it is within one f32 ulp
of the largest prefix (38.4 in the corner case: 3.8e-6, 1.15e-6 of the
largest entry, 3.31), and the reference's corner scan is 4.0e-6 off the
float64 sums itself. Position gradients at 1e-5 of the largest entry
(sums of res-scaled products over 8 corners and 3 levels)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.ops import hashgrid as t_hg
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.ops import hashgrid as j_hg
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

torch.set_num_threads(1)

LOG2_T, F, N = 10, 2, 301
T = 2**LOG2_T
RES = (4, 9, 31)
L = len(RES)
TABLE_RTOL, TABLE_REF_RTOL, DX_RTOL = 1e-6, 2e-6, 1e-5

# The reference's plain encodes and sorted VJPs, by layout.
J_ENCODE = {"corner": j_hg.encode, "quad": j_hg.encode_quad, "oct": j_hg.encode_oct,
            "osplit": j_hg.encode_oct_split}
J_SORTED = {"corner": j_hg._sorted_grad_encode, "quad": j_hg._quad_grad_encode,
            "oct": j_hg._oct_grad_encode, "osplit": j_hg._oct_split_grad_encode}
T_ENCODE = {"corner": t_hg.encode, "quad": t_hg.encode_quad, "oct": t_hg.encode_oct,
            "osplit": t_hg.encode_oct_split}
T_SORTED = {"corner": t_hg.CornerEncode, "quad": t_hg.QuadEncode, "oct": t_hg.OctEncode,
            "osplit": t_hg.OctSplitEncode}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    x = rng.uniform(-0.05, 1.05, (N, 3)).astype(np.float32)
    table = rng.normal(0.0, 0.1, (L, T, F)).astype(np.float32)
    g = rng.normal(size=(N, L * F)).astype(np.float32)
    return x, table, g


def test_levels_are_dense_boundary_and_hashed():
    assert [(r + 1) ** 3 <= T for r in RES] == [True, True, False]
    assert (RES[1] + 1) ** 3 + max(t_hg._oct_offsets(RES[1], T)) > T


def test_corner_hash_matches_exactly():
    """XOR of int64 products masked with T - 1 equals the reference's
    wrapping uint32 hash; dense levels index z-major (x + y s + z s^2)."""
    rng = np.random.default_rng(1)
    for res, log2_t in ((31, 10), (9, 10), (32768, 19), (2048, 19)):
        coords = rng.integers(0, res + 1, (4096, 3)).astype(np.int32)
        coords[0] = res
        want = j_hg._hash_corner(jnp.asarray(coords), res, 2**log2_t)
        got = t_hg._hash_corner(torch.from_numpy(coords).to(torch.int64), res, 2**log2_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(t_hg._hash_corner(torch.tensor([1, 0, 0]), 9, T)) == 1
    assert int(t_hg._hash_corner(torch.tensor([0, 0, 1]), 9, T)) == 100


@pytest.mark.parametrize("layout", ["corner", "quad", "oct"])
def test_indices_and_weights(inputs, layout):
    x, *_ = inputs
    fn = {"corner": "_corner_indices_weights", "quad": "_quad_indices_weights",
          "oct": "_oct_indices_weights"}[layout]
    j_idx, j_w = getattr(j_hg, fn)(jnp.asarray(x), np.asarray(RES), T)
    t_idx, t_w = getattr(t_hg, fn)(torch.from_numpy(x), RES, T)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layout", ["quad", "oct"])
def test_physical_tables_exactly(inputs, layout):
    _, table, _ = inputs
    build = {"quad": "build_quad_table", "oct": "build_oct_table"}[layout]
    want = getattr(j_hg, build)(jnp.asarray(table), np.asarray(RES), T)
    got = getattr(t_hg, build)(torch.from_numpy(table), RES, T)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout,pack", [("corner", 0), ("corner", 4), ("corner", 64),
                                         ("quad", 0), ("oct", 0)])
def test_forwards_match(inputs, layout, pack):
    x, table, _ = inputs
    kw = {"pack_rows": pack} if layout == "corner" else {}
    want = J_ENCODE[layout](jnp.asarray(x), jnp.asarray(table), np.asarray(RES), T, **kw)
    got = T_ENCODE[layout](torch.from_numpy(x), torch.from_numpy(table), RES, T, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2


def test_oct_and_quad_share_the_hash(inputs):
    """The same outputs from either layout's table (the reference's
    interchangeability, which checkpoints rely on)."""
    x, table, _ = inputs
    args = (torch.from_numpy(x), torch.from_numpy(table), RES, T)
    np.testing.assert_allclose(t_hg.encode_oct(*args).numpy(), t_hg.encode_quad(*args).numpy(),
                               atol=1e-6)


def _assert_grads(got_dx, got_dt, want_dx, want_dt, table_rtol=TABLE_RTOL):
    want_dt, want_dx = np.asarray(want_dt), np.asarray(want_dx)
    assert float(np.abs(want_dt).max()) > 0.1
    np.testing.assert_allclose(got_dt, want_dt, rtol=0,
                               atol=table_rtol * float(np.abs(want_dt).max()))
    np.testing.assert_allclose(got_dx, want_dx, rtol=0,
                               atol=DX_RTOL * float(np.abs(want_dx).max()))


def _torch_grads(fn, x, table, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    out = fn(xt, tt)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), tt.grad.numpy()


@pytest.mark.parametrize("layout", ["corner", "quad", "oct", "osplit"])
def test_sorted_gradients_match_the_reference_vjp(inputs, layout):
    x, table, g = inputs
    fn = J_SORTED[layout](RES, T)
    want_out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(table))
    want_dx, want_dt = vjp(jnp.asarray(g))
    out, dx, dt = _torch_grads(lambda a, b: T_SORTED[layout].apply(a, b, RES, T), x, table, g)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=1e-6, atol=1e-6)
    _assert_grads(dx, dt, want_dx, want_dt, TABLE_REF_RTOL)
    if layout == "osplit":
        # Its plain encode reads bf16 tables, whose autograd rounds the
        # table gradient to bf16; tests/test_torch_hashgrid_grad.py holds it
        # against float64 sums of the bf16 products instead.
        return
    # The same f32 weights and cotangent, their products and sums in float64:
    # autograd of the plain encode on a float64 table.
    _, dx64, dt64 = _torch_grads(lambda a, b: T_ENCODE[layout](a, b, RES, T), x,
                                 table.astype(np.float64), g.astype(np.float64))
    _assert_grads(dx, dt, dx64, dt64, TABLE_REF_RTOL)


@pytest.mark.parametrize("layout,pack", [("corner", 0), ("corner", 64), ("quad", 0), ("oct", 0)])
def test_scatter_gradients_match_autodiff(inputs, layout, pack):
    """grad_mode="scatter" (and pack_rows, which always differentiates the
    gathers) against jax.grad of the reference's plain encodes."""
    x, table, g = inputs
    kw = {"pack_rows": pack} if layout == "corner" else {}
    loss = lambda a, b: jnp.sum(J_ENCODE[layout](a, b, np.asarray(RES), T, **kw) * g)
    want_dx, want_dt = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                               jnp.asarray(table))
    _, dx, dt = _torch_grads(lambda a, b: T_ENCODE[layout](a, b, RES, T, **kw), x, table, g)
    _assert_grads(dx, dt, want_dx, want_dt)


@pytest.mark.parametrize("layout", ["corner", "quad", "oct"])
def test_sorted_and_scatter_agree(inputs, layout):
    x, table, g = inputs
    _, dx_s, dt_s = _torch_grads(lambda a, b: T_SORTED[layout].apply(a, b, RES, T), x, table, g)
    _, dx_a, dt_a = _torch_grads(lambda a, b: T_ENCODE[layout](a, b, RES, T), x, table, g)
    _assert_grads(dx_s, dt_s, dx_a, dt_a, TABLE_REF_RTOL)


@pytest.mark.parametrize("m,n_rows,high", [(2000, 300, 250), (50, 7, 7)])
def test_row_sums_match_both_reference_pipelines(m, n_rows, high):
    rng = np.random.default_rng(m)
    idx = rng.integers(0, high, m).astype(np.int32)  # rows >= high stay empty
    vals = rng.normal(size=(m, 8)).astype(np.float32)
    got = t_hg._sorted_row_sums(torch.from_numpy(idx).to(torch.int64), torch.from_numpy(vals),
                                n_rows).numpy()
    assert got.shape == (n_rows, 8) and np.all(got[high:] == 0)
    for fn in (j_hg._sorted_row_sums, j_hg._sorted_row_sums_gather):
        want = np.asarray(fn(jnp.asarray(idx), jnp.asarray(vals), n_rows))
        np.testing.assert_allclose(got, want, rtol=0, atol=TABLE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("env", [{"ONDT_OSPLIT_ROWSUMS": "merged"},
                                 {"ONDT_OSPLIT_GRAD_GATHER": "f32"}])
def test_osplit_backward_reads_no_reference_switch(inputs, monkeypatch, env):
    """A deliberate difference: the port keeps the reference's default osplit
    backward (bf16 products, sorted per level) and reads none of its
    environment switches, so under each switch it gives the same gradients
    as without it, and those of the reference without it. Both round the
    same f32 products to bf16; a product a rounding apart in the two
    packages moves its row by one bf16 ulp of it, so the table gradient is
    held at 1e-4 of the largest entry."""
    x, table, g = inputs
    fn = j_hg._oct_split_grad_encode(RES, T)
    want_dx, want_dt = jax.vjp(fn, jnp.asarray(x), jnp.asarray(table))[1](jnp.asarray(g))
    encode = lambda a, b: t_hg.OctSplitEncode.apply(a, b, RES, T)  # noqa: E731
    _, dx_default, dt_default = _torch_grads(encode, x, table, g)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    _, dx, dt = _torch_grads(encode, x, table, g)
    assert np.array_equal(dt, dt_default) and np.array_equal(dx, dx_default)
    want_dt = np.asarray(want_dt)
    np.testing.assert_allclose(dt, want_dt, rtol=0, atol=1e-4 * np.abs(want_dt).max())
    np.testing.assert_allclose(dx, np.asarray(want_dx), rtol=0,
                               atol=DX_RTOL * np.abs(np.asarray(want_dx)).max())


@pytest.mark.parametrize("layout", ["corner", "quad", "oct", "osplit"])
def test_encoding_module_dispatch(inputs, layout):
    """The module's forward equals the layout's encode, with and without
    prepared tables; "auto" and "sorted" run the sorted Function, "scatter"
    autograd."""
    x, table, _ = inputs
    kw = dict(n_levels=L, n_features=F, log2_table_size=LOG2_T, base_resolution=4,
              max_resolution=31, layout=layout)
    enc = t_hg.HashGridEncoding(**kw)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    xt = torch.from_numpy(x)
    want = T_ENCODE[layout](xt, enc.table.detach(), enc.resolutions, T)
    out = enc(xt)
    assert out.grad_fn.name().startswith(T_SORTED[layout].__name__)
    np.testing.assert_array_equal(out.detach().numpy(), want.numpy())
    prepared = enc.prepare()
    assert (prepared is None) == (layout in ("corner", "osplit"))
    with torch.no_grad():
        np.testing.assert_array_equal(enc(xt, prepared=prepared).numpy(), want.numpy())
    scatter = t_hg.HashGridEncoding(**kw, grad_mode="scatter")
    with torch.no_grad():
        scatter.table.copy_(torch.from_numpy(table))
    out = scatter(xt)
    assert not out.grad_fn.name().startswith(T_SORTED[layout].__name__)


def test_pack_rows_module_rules(inputs):
    """A pack that does not divide L*T is off, as in the reference; packed
    rows take plain autograd; a linear-hash layout refuses any pack."""
    x, table, _ = inputs
    kw = dict(n_levels=L, n_features=F, log2_table_size=LOG2_T, base_resolution=4,
              max_resolution=31, layout="corner")
    assert t_hg.HashGridEncoding(**kw, pack_rows=5).pack_rows == 0
    assert t_hg.HashGridEncoding(**kw, pack_rows=64).pack_rows == 64
    enc = t_hg.HashGridEncoding(**kw, pack_rows=64)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    out = enc(torch.from_numpy(x))
    assert not out.grad_fn.name().startswith("CornerEncode")
    for layout in ("osplit", "oct", "quad"):
        with pytest.raises(ValueError, match="pack_rows"):
            t_hg.HashGridEncoding(**dict(kw, layout=layout), pack_rows=64)
    with pytest.raises(ValueError, match="grad_mode"):
        t_hg.HashGridEncoding(**kw, grad_mode="sortd")


# ---- one tiny train step per layout, as tests/test_torch_ngp.py holds osplit's

CONFIG = "configs/kitti_ngp.json"
FIELD = dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
             hidden_width=16, geo_features=7, grad_mode="sorted")
MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16, sample_budget=8)


def _flat_flax(tree):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            elif k == "kernel":
                out[".".join(prefix + ["weight"])] = np.asarray(v).T
            else:
                out[".".join(prefix + [k])] = np.asarray(v)

    walk(tree["params"], [])
    return out


def _to_torch(obj):
    import dataclasses

    from outdoor_nerf_depth_torch.data import rays as t_rays

    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    a = np.asarray(obj)
    return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a.copy())


def _flat_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("layout", ["corner", "quad", "oct"])
def test_train_step_matches_the_reference(layout):
    params = dict(MODEL, field_params=dict(FIELD, hash_layout=layout))
    args = ["dataset=synthetic", "batch_size=64", "max_steps=3", "randomized=false",
            "exp_dir=unused", "model_params=" + json.dumps(params)]
    config_j, config_t = j_load_config(CONFIG, args), t_load_config(CONFIG, args)
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    batch = dataset.sample_batch()
    rng = np.random.default_rng(1)
    grid = rng.uniform(0.0, 2.0, (1, 16**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.6] = 0.0
    mesh = parallel.make_mesh(jax.devices()[:1])
    model_j, state = j_step.init_state(config_j, jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    step_j = j_step.make_train_step(config_j, model_j, mesh, cameras=dataset.cameras,
                                    camtype=dataset.camtype)
    state, stats_j = step_j(state, parallel.shard_batch(batch, mesh), jax.random.PRNGKey(0), 0.0,
                            jnp.asarray(grid))
    as_port = lambda tree: _flat_params(convert.params_from_flax(jax.device_get(tree),
                                                                 t_step.build_model(config_t)))
    params_j, grads_j = as_port(state.params), as_port(state.opt_state[0].mu)

    model_t = convert.params_from_flax(params0, t_step.build_model(config_t))
    assert model_t.field.encoder.layout == layout
    model_t.occupancy.copy_(torch.from_numpy(grid))
    optimizer, lr_fn = t_step.make_optimizer(config_t, model_t)
    cams = tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras)
    step_t = t_step.make_train_step(config_t, model_t, optimizer, lr_fn, cameras=cams)
    stats_t = step_t(_to_torch(batch), 0, 0.0, None)
    # Adam's first moment after one step is (1 - beta1) times the gradient.
    grads_t = {n: optimizer.state[p]["exp_avg"].numpy() for n, p in model_t.named_parameters()}
    params_t = _flat_params(model_t)
    # tests/test_torch_ngp.py's tolerances: loss terms at relative 2e-5, the
    # gradient norm at 1e-4, parameters at 5e-5 absolute and 1e-5 relative.
    for k, v in stats_j["loss_terms"].items():
        np.testing.assert_allclose(float(stats_t["loss_terms"][k]), float(v), rtol=2e-5,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]),
                               rtol=1e-4)
    assert set(params_t) == set(params_j) == set(grads_t) == set(grads_j)
    for name in params_j:
        atol = np.full(params_j[name].shape, 5e-5)
        if name == "field.encoder.table":
            # The table's gradient (Adam's first moment, (1 - beta1) g) at
            # TABLE_REF_RTOL of its largest entry: a sorted row's sum is a
            # difference of f32 prefix sums, a few ulps of the largest one
            # off, even in rows no point reached. Adam's first step moves a
            # weight by lr f(g), f(g) = g / (|g| + eps), whose slope
            # eps / (|g| + eps)^2 is 1 / eps at 0; here that tolerance of g
            # is 0.17 eps, so an entry whose |g| lies within a few eps of 0
            # is sensitive even above the tolerance. An entry with a nonzero
            # gradient in either package is held at lr times the tolerance
            # times f's largest slope within the tolerance of its reference
            # gradient (at most 0.17 lr, at g near 0; below 5e-5 above
            # |g| ~ 6 eps); every other entry at 5e-5, as every parameter.
            g = np.abs(grads_j[name])
            grad_atol = TABLE_REF_RTOL * g.max()
            np.testing.assert_allclose(grads_t[name], grads_j[name], rtol=0, atol=grad_atol)
            lr, eps = config_t.lr_init, config_t.adam_eps
            delta = grad_atol / (1.0 - config_t.adam_beta1)
            near = np.maximum(g / (1.0 - config_t.adam_beta1) - delta, 0.0)
            moved = (g > 0) | (grads_t[name] != 0)
            atol[moved] = np.maximum(5e-5, lr * delta * eps / (near[moved] + eps) ** 2)
            print(f"{layout}: {int((atol > 5e-5).sum())} of {int(moved.sum())} table entries "
                  f"with a gradient above 5e-5, at most {float(atol.max()):.3g}")
        err = np.abs(params_t[name] - params_j[name]) - 1e-5 * np.abs(params_j[name])
        assert (err <= atol).all(), (name, float((err - atol).max()))
