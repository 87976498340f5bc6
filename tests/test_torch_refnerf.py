"""The Ref-NeRF options of the port against the reference package on the
CPU: `ops/refdirs.py` (reflection, angular error, the integrated
directional encoding at degrees 1 to 5), the cone MLP under each option set
of the reference's own normal tests plus GLO and noise (outputs, the
density-gradient normals, and parameter gradients of a loss on all of them,
which differentiate through that gradient), in bf16, cylinder rays and the
composited normals and roughness, the orientation and predicted-normal
losses, and the rawnerf rgb loss. Same weights (converted by
`params_from_flax`) and numpy inputs from a seed; JAX at highest matmul
precision.

Tolerances: outputs of float32 layers at relative 1e-5; normals are unit
vectors (their largest entry is ~1) held at 1e-5 absolute; the IDE's
z-polynomials of degree 16 cancel terms of up to ~3e5 to results below 1,
so both packages' float32 sums carry errors of a few ulps of those terms:
the IDE is held to 1e-6 of the sum of the magnitudes of its terms (1e-6
absolute where they stay below 1, degrees 1 and 2). Parameter gradients at
relative 1e-4 and 1e-6 of the largest entry of their layer: the second
derivative sums products over the whole batch in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.models.mlps import ConeFieldMLP as TConeFieldMLP
from outdoor_nerf_depth_torch.ops import refdirs as t_refdirs
from outdoor_nerf_depth_torch.ops import volren as t_volren
from outdoor_nerf_depth_torch.train import losses as t_losses
from outdoor_nerf_depth_tpu.models.mlps import ConeFieldMLP as JConeFieldMLP
from outdoor_nerf_depth_tpu.ops import refdirs as j_refdirs
from outdoor_nerf_depth_tpu.ops import volren as j_volren
from outdoor_nerf_depth_tpu.train import losses as j_losses

torch.set_num_threads(1)

SMALL = dict(net_depth=2, net_width=16, bottleneck_width=8, net_width_viewdirs=8)
# The option sets of the reference's normal tests, then GLO, predicted
# normals driving reflections, and everything at once with skip layers.
OPTION_SETS = {
    "density_and_pred_normals": dict(SMALL, max_deg_point=4, compute_density_normals=True,
                                     enable_pred_normals=True),
    "density_normals_no_rgb": dict(SMALL, max_deg_point=2, compute_density_normals=True,
                                   disable_rgb=True),
    "reflections_ide_roughness_ndotv": dict(SMALL, max_deg_point=2, compute_density_normals=True,
                                            use_reflections=True, use_directional_enc=True,
                                            enable_pred_roughness=True, use_n_dot_v=True),
    "glo": dict(SMALL, max_deg_point=4, num_glo_features=4),
    "pred_normals_reflections_pe": dict(SMALL, max_deg_point=3, enable_pred_normals=True,
                                        use_reflections=True, use_n_dot_v=True),
    "everything_contract_skips": dict(
        net_depth=3, net_width=16, bottleneck_width=8, net_depth_viewdirs=3,
        net_width_viewdirs=8, skip_layer=1, skip_layer_dir=1, max_deg_point=3, deg_view=5,
        compute_density_normals=True, enable_pred_normals=True, use_directional_enc=True,
        use_reflections=True, enable_pred_roughness=True, roughness_bias=-0.5,
        use_n_dot_v=True, num_glo_features=3, warp="contract"),
}
OUT_KEYS = ("density", "rgb", "normals", "normals_pred", "roughness")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(params, n=4, s=5, seed=3):
    rng = np.random.default_rng(seed)
    spread = 2.5 if params.get("warp") == "contract" else 0.4
    means = rng.uniform(-spread, spread, (n, s, 3)).astype(np.float32)
    a = rng.normal(size=(n, s, 3, 3)).astype(np.float32) * 0.02
    covs = (a @ np.swapaxes(a, -1, -2) + 1e-4 * np.eye(3)).astype(np.float32)
    viewdirs = _unit(rng.normal(size=(n, 3)))
    glo = rng.normal(size=(n, params.get("num_glo_features", 0))).astype(np.float32)
    return means, covs, viewdirs, glo if params.get("num_glo_features") else None


def _loss_weights(n=4, s=5, seed=7):
    rng = np.random.default_rng(seed)
    return {"density": rng.normal(size=(n, s)), "rgb": rng.normal(size=(n, s, 3)),
            "normals": rng.normal(size=(n, s, 3)), "normals_pred": rng.normal(size=(n, s, 3)),
            "roughness": rng.normal(size=(n, s, 1))}


def _jax_mlp(params, inputs, rng=None):
    """The reference MLP's variables, outputs and the gradient of a weighted
    sum of every output."""
    mlp = JConeFieldMLP(**params)
    means, covs, viewdirs, glo = inputs
    variables = jax.jit(lambda k: mlp.init(k, None, means, covs, viewdirs, glo))(
        jax.random.PRNGKey(1))
    lw = _loss_weights()

    def loss(v):
        out = mlp.apply(v, rng, means, covs, viewdirs, glo)
        total = sum(jnp.sum(out[k] * lw[k]) for k in OUT_KEYS if out.get(k) is not None)
        return total, out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    return mlp, jax.device_get(variables), jax.device_get(out), jax.device_get(grad)


def _torch_mlp(params, variables, inputs, generator=None):
    mlp = convert.params_from_flax(variables, TConeFieldMLP(**params))
    means, covs, viewdirs, glo = (None if x is None else torch.from_numpy(x) for x in inputs)
    out = mlp(means, covs, viewdirs, glo_vec=glo, generator=generator)
    lw = _loss_weights()
    total = sum(torch.sum(out[k] * torch.from_numpy(lw[k]).float())
                for k in OUT_KEYS if out.get(k) is not None)
    total.backward()
    return mlp, out


def _check_outputs(got, want, normals_atol=1e-5, rtol=1e-5, atol=1e-6):
    for key in OUT_KEYS:
        if want.get(key) is None:
            assert got.get(key) is None, key
            continue
        g = got[key].detach().numpy()
        tol = dict(atol=normals_atol) if key.startswith("normals") else dict(rtol=rtol, atol=atol)
        np.testing.assert_allclose(g, np.asarray(want[key]), err_msg=key, **tol)


def _check_grads(mlp, grad):
    flat = dict(convert._flatten(grad["params"]))
    for path, g_j in flat.items():
        *module, leaf = path
        layer = getattr(mlp, ".".join(module))
        g_t = (layer.weight.grad.T if leaf == "kernel" else layer.bias.grad).numpy()
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-6 * np.abs(g_j).max() + 1e-9,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_cone_mlp_options_match(name):
    params = OPTION_SETS[name]
    inputs = _inputs(params)
    _, variables, want, grad = _jax_mlp(params, inputs)
    mlp, got = _torch_mlp(params, variables, inputs)
    _check_outputs(got, want)
    _check_grads(mlp, grad)
    if params.get("compute_density_normals"):
        n = got["normals"].detach().numpy()
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


def test_cone_mlp_noise_draws_match(monkeypatch):
    """Density then bottleneck noise, drawn from the generator: the
    reference's own draws (its key split for each) fed in as torch's."""
    params = dict(OPTION_SETS["reflections_ide_roughness_ndotv"], density_noise=0.3,
                  bottleneck_noise=0.2)
    inputs = _inputs(params)
    key = jax.random.PRNGKey(11)
    _, variables, want, grad = _jax_mlp(params, inputs, rng=key)
    rng, k1 = jax.random.split(key)
    _, k2 = jax.random.split(rng)
    draws = [np.asarray(jax.random.normal(k1, inputs[0].shape[:-1])),
             np.asarray(jax.random.normal(k2, inputs[0].shape[:-1] + (SMALL["bottleneck_width"],)))]
    calls = []

    def fake_randn(shape, generator=None, dtype=None, device=None):
        assert generator is not None and tuple(shape) == draws[len(calls)].shape
        calls.append(shape)
        return torch.from_numpy(np.array(draws[len(calls) - 1])).to(dtype)

    monkeypatch.setattr(torch, "randn", fake_randn)
    mlp, got = _torch_mlp(params, variables, inputs, generator=torch.Generator())
    assert len(calls) == 2
    _check_outputs(got, want)
    _check_grads(mlp, grad)
    # Without a generator nothing is drawn, as without a key.
    calls.clear()
    _torch_mlp(params, variables, inputs)
    assert not calls


def test_cone_mlp_noise_moments():
    """The density noise the port draws itself: N(0, noise^2) on the raw
    density, none without a generator."""
    params = dict(SMALL, max_deg_point=2, disable_rgb=True, density_noise=0.5, density_bias=0.0)
    mlp = TConeFieldMLP(**params, generator=torch.Generator().manual_seed(0))
    means = torch.zeros((4000, 1, 3))
    covs = torch.eye(3).expand(4000, 1, 3, 3) * 1e-4
    with torch.no_grad():
        clean = mlp(means, covs)["density"]
        noisy = mlp(means, covs, generator=torch.Generator().manual_seed(1))["density"]
    # softplus is invertible: recover the raw density's noise.
    noise = torch.log(torch.expm1(noisy)) - torch.log(torch.expm1(clean))
    assert abs(float(noise.mean())) < 0.05 and abs(float(noise.std()) - 0.5) < 0.05
    assert torch.equal(clean, mlp(means, covs)["density"].detach())


def test_cone_mlp_bf16_matches():
    """bf16 layers: the forward and the density gradient run through them
    in both packages (rgb at 5e-3 as for the other bf16 renderings; the
    normals, normalized gradients of a bf16 trunk, at 3e-2)."""
    params = dict(OPTION_SETS["everything_contract_skips"], compute_dtype=jnp.bfloat16)
    inputs = _inputs(params)
    _, variables, want, _ = _jax_mlp(params, inputs)
    mlp, got = _torch_mlp(dict(params, compute_dtype="bfloat16"), variables, inputs)
    np.testing.assert_allclose(got["rgb"].detach().numpy(), want["rgb"], atol=5e-3)
    for key in ("normals", "normals_pred"):
        np.testing.assert_allclose(got[key].detach().numpy(), want[key], atol=3e-2, err_msg=key)
    _, f32 = _torch_mlp(dict(params, compute_dtype="float32"), variables, inputs)
    assert not np.allclose(f32["normals"].detach().numpy(), got["normals"].detach().numpy(),
                           atol=1e-6)


def test_reflections_need_normals():
    with pytest.raises(ValueError, match="requires normals"):
        TConeFieldMLP(**SMALL, use_reflections=True)


def test_density_normals_under_no_grad_are_detached():
    params = OPTION_SETS["density_and_pred_normals"]
    mlp = TConeFieldMLP(**params, generator=torch.Generator().manual_seed(0))
    means, covs, viewdirs, _ = (None if x is None else torch.from_numpy(x)
                                for x in _inputs(params))
    with torch.no_grad():
        out = mlp(means, covs, viewdirs)
    assert all(v is None or not v.requires_grad for v in out.values())
    with_grad = mlp(means, covs, viewdirs)
    assert with_grad["normals"].requires_grad
    torch.testing.assert_close(out["normals"], with_grad["normals"].detach(), rtol=0, atol=0)


# -- ops/refdirs.py ---------------------------------------------------------


def test_l2_normalize_reflect_and_mae():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    x[0] = 0.0  # the eps floor
    n = _unit(rng.normal(size=(64, 3)))
    w = rng.uniform(size=64).astype(np.float32)
    pairs = [
        (t_refdirs.l2_normalize(torch.from_numpy(x)), j_refdirs.l2_normalize(x)),
        (t_refdirs.reflect(torch.from_numpy(x), torch.from_numpy(n)), j_refdirs.reflect(x, n)),
        (t_refdirs.weighted_mae_degrees(torch.from_numpy(w[1:]), torch.from_numpy(_unit(x[1:])),
                                        torch.from_numpy(n[1:])),
         j_refdirs.weighted_mae_degrees(w[1:], _unit(x[1:]), n[1:])),
        # Equal normals: the clip keeps arccos finite.
        (t_refdirs.weighted_mae_degrees(torch.from_numpy(w), torch.from_numpy(n),
                                        torch.from_numpy(n)),
         j_refdirs.weighted_mae_degrees(w, n, n)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_ide_matches(deg):
    rng = np.random.default_rng(deg)
    d = _unit(rng.normal(size=(512, 3)))
    kappa_inv = rng.uniform(0, 0.5, size=(512, 1)).astype(np.float32)
    want = np.asarray(jax.jit(j_refdirs.generate_ide_fn(deg))(d, kappa_inv))
    got = t_refdirs.generate_ide_fn(deg)(torch.from_numpy(d), torch.from_numpy(kappa_inv))
    ml, mat = j_refdirs._ide_tables(deg)
    vmz = np.abs(d[:, 2:3].astype(np.float64)) ** np.arange(mat.shape[0])
    terms = np.concatenate([vmz @ np.abs(mat)] * 2, axis=-1)  # per column, >= |result|
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * max(1.0, terms.max()))
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * np.maximum(terms, 1.0))
    np.testing.assert_array_equal(t_refdirs._ide_tables(deg)[0], ml)
    np.testing.assert_array_equal(t_refdirs._ide_tables(deg)[1], mat)
    enc = t_refdirs.generate_dir_enc_fn(deg)(torch.from_numpy(d))
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_refdirs.generate_dir_enc_fn(deg)(d)),
                               atol=1e-6 * max(1.0, terms.max()))


def test_ide_degree_six_raises():
    with pytest.raises(ValueError, match="unstable"):
        t_refdirs.generate_ide_fn(6)


# -- ops/volren.py: cylinders and composited extras ---------------------------


def test_cylinder_cast_and_unknown_shape():
    rng = np.random.default_rng(5)
    tdist = np.sort(rng.uniform(0.5, 4.0, (6, 9)), axis=-1).astype(np.float32)
    origins = rng.normal(size=(6, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    radii = rng.uniform(1e-3, 1e-2, (6, 1)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (tdist, origins, dirs, radii)]
    for diagonal in (False, True):
        got = t_volren.cast_rays(*args, ray_shape="cylinder", diagonal=diagonal)
        want = j_volren.cast_rays(tdist, origins, dirs, radii, ray_shape="cylinder",
                                  diagonal=diagonal)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="cone|cylinder"):
        t_volren.cast_rays(*args, ray_shape="sphere")


def test_composite_extras():
    rng = np.random.default_rng(6)
    n, s = 5, 7
    weights = rng.uniform(0, 0.2, (n, s)).astype(np.float32)
    tdist = np.sort(rng.uniform(0.5, 4.0, (n, s + 1)), axis=-1).astype(np.float32)
    rgbs = rng.uniform(size=(n, s, 3)).astype(np.float32)
    far = np.full((n, 1), 4.0, np.float32)
    extras = {"normals": _unit(rng.normal(size=(n, s, 3))),
              "roughness": rng.uniform(size=(n, s, 1)).astype(np.float32),
              "normals_pred": None}
    got = t_volren.composite(torch.from_numpy(rgbs), torch.from_numpy(weights),
                             torch.from_numpy(tdist), 0.5, torch.from_numpy(far), True,
                             extras={k: None if v is None else torch.from_numpy(v)
                                     for k, v in extras.items()})
    want = j_volren.composite(rgbs, weights, tdist, 0.5, far, True, extras=extras)
    assert set(got) == set(want) and "normals_pred" not in got
    for key in ("normals", "roughness"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-7)


# -- losses ------------------------------------------------------------------


def _history(rng, levels=2, n=6, s=5, fields=("normals", "normals_pred")):
    return [dict(weights=rng.uniform(0, 0.3, (n, s)).astype(np.float32),
                 **{f: _unit(rng.normal(size=(n, s, 3))) for f in fields})
            for _ in range(levels)]


def _torch_history(hist):
    return [{k: torch.tensor(v, requires_grad=True) for k, v in level.items()} for level in hist]


def _check_loss_and_grads(t_fn, j_fn, hist):
    t_hist = _torch_history(hist)
    got = t_fn(t_hist)
    got.backward()
    want, grads = jax.value_and_grad(j_fn)(hist)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t_level, j_level in zip(t_hist, grads):
        for k, v in t_level.items():
            g = torch.zeros_like(v) if v.grad is None else v.grad  # a field the loss skips
            np.testing.assert_allclose(g.numpy(), np.asarray(j_level[k]), rtol=1e-5,
                                       atol=1e-8, err_msg=k)


@pytest.mark.parametrize("target", ["normals", "normals_pred"])
def test_orientation_loss_matches(target):
    rng = np.random.default_rng(8)
    hist = _history(rng)
    viewdirs = _unit(rng.normal(size=(6, 3)))
    _check_loss_and_grads(
        lambda h: t_losses.orientation_loss(h, torch.from_numpy(viewdirs), 0.1, 0.01, target),
        lambda h: j_losses.orientation_loss(h, viewdirs, 0.1, 0.01, target), hist)
    with pytest.raises(ValueError, match=target):
        t_losses.orientation_loss(_torch_history(_history(rng, fields=())),
                                  torch.from_numpy(viewdirs), 0.1, 0.01, target)


def test_predicted_normal_loss_matches():
    rng = np.random.default_rng(9)
    hist = _history(rng, levels=3)
    _check_loss_and_grads(lambda h: t_losses.predicted_normal_loss(h, 3e-5, 3e-4),
                          lambda h: j_losses.predicted_normal_loss(h, 3e-5, 3e-4), hist)
    for fields in (("normals",), ("normals_pred",)):
        with pytest.raises(ValueError, match="both normal fields"):
            t_losses.predicted_normal_loss(_torch_history(_history(rng, fields=fields)), 0, 1)


def test_rawnerf_loss_matches_with_a_tie_at_one():
    rng = np.random.default_rng(10)
    pred = rng.uniform(-0.01, 1.2, (64, 3)).astype(np.float32)
    pred[:4] = 1.0  # rgb_padding lets the prediction reach exactly 1
    target = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    lossmult = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    p = torch.tensor(pred, requires_grad=True)
    loss, mse = t_losses.rgb_loss(p, torch.from_numpy(target), torch.from_numpy(lossmult),
                                  kind="rawnerf")
    loss.backward()
    (want, want_mse), grad = jax.value_and_grad(
        lambda x: j_losses.rgb_loss(x, target, lossmult, kind="rawnerf"), has_aux=True)(pred)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(mse.item(), float(want_mse), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-8)
    # At the tie min(1, pred) passes on half the gradient, as the
    # reference's does; a clamp would pass on all of it.
    c = torch.tensor(pred, requires_grad=True)
    clamped = torch.clamp(c, max=1.0)
    scale = 1.0 / (1e-3 + clamped.detach())
    mult = torch.from_numpy(lossmult).expand(c.shape)
    ((mult * (clamped - torch.from_numpy(target)) ** 2 * scale**2).sum() / mult.sum()).backward()
    assert np.all(p.grad.numpy()[:4] != 0)
    np.testing.assert_allclose(p.grad.numpy()[:4], 0.5 * c.grad.numpy()[:4], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown rgb loss"):
        t_losses.rgb_loss(p, torch.from_numpy(target), kind="huber")
