"""ConeFieldMLP and ProposalModel of the port against the reference package,
with the same weights (converted by `params_from_flax`) on the same rays,
deterministic path (`rng=None` / `generator=None`), on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.models import build as t_build
from outdoor_nerf_depth_torch.models.mlps import ConeFieldMLP as TConeFieldMLP
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.models import build as j_build
from outdoor_nerf_depth_tpu.models.mlps import ConeFieldMLP as JConeFieldMLP

# The suite runs files in parallel worker processes: one torch thread per
# worker keeps these small CPU tests from crowding the timing-sensitive
# tests of other workers.
torch.set_num_threads(1)

NERF = dict(net_depth=3, net_width=32, bottleneck_width=16, net_width_viewdirs=16, max_deg_point=4)
PROP = dict(net_depth=2, net_width=16, max_deg_point=4)
MODELS = {
    "flagship_options": dict(
        num_prop_samples=16, num_nerf_samples=8, num_levels=3, raydist_fn="reciprocal",
        opaque_background=True, single_jitter=True,
        nerf_mlp_params=NERF, prop_mlp_params=PROP,
    ),
    "skip_layers_two_levels": dict(
        num_prop_samples=12, num_nerf_samples=6, num_levels=2, raydist_fn="log",
        near_anneal_rate=0.8, bg_intensity_range=(0.0, 1.0),
        nerf_mlp_params=dict(NERF, skip_layer=2), prop_mlp_params=dict(PROP, skip_layer=1),
    ),
}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _image_rays():
    batch = j_datasets.SyntheticDataset("test", global_batch_size=16, seed=3).image_batch(0)
    # The reference casts host rays in float64 numpy and runs them in float32.
    flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
            for k, v in dataclasses.asdict(batch.rays).items() if v is not None}
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in flat.items()}
    return j_rays.Rays(**flat), t_rays.Rays(**{k: torch.from_numpy(v) for k, v in flat.items()})


def _init(j_model):
    return jax.jit(lambda k: j_model.init(k, rng=None, rays=j_rays.dummy_rays((8,)),
                                          train_frac=1.0, compute_extras=False))(
        jax.random.PRNGKey(0))


def _to_torch_model(jax_vars, params):
    model = t_build("mipnerf360", **params)
    return convert.params_from_flax(jax.device_get(jax_vars), model)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_proposal_model_levels_match(name):
    params = MODELS[name]
    j_model = j_build("mipnerf360", **params)
    j_vars = _init(j_model)
    t_model = _to_torch_model(j_vars, params)
    jr, tr = _image_rays()
    j_render, j_hist = jax.jit(
        lambda v, r: j_model.apply(v, None, r, train_frac=0.5, compute_extras=True)
    )(j_vars, jr)
    with torch.no_grad():
        t_render, t_hist = t_model(tr, train_frac=0.5, compute_extras=True, generator=None)
    assert len(t_render) == len(j_render) == params["num_levels"]
    for level, (tr_l, jr_l, th_l, jh_l) in enumerate(zip(t_render, j_render, t_hist, j_hist)):
        msg = f"{name} level {level}"
        # Resampled edges go through an inverse CDF whose slope amplifies
        # float32 roundoff of the weights: 2e-5 in normalized distance.
        np.testing.assert_allclose(th_l["sdist"].numpy(), np.asarray(jh_l["sdist"]), atol=2e-5, err_msg=msg)
        # Weights difference transmittances over those edges: 5e-5.
        np.testing.assert_allclose(th_l["weights"].numpy(), np.asarray(jh_l["weights"]), atol=5e-5, err_msg=msg)
        np.testing.assert_allclose(tr_l["rgb"].numpy(), np.asarray(jr_l["rgb"]), atol=2e-5, err_msg=msg)
        # Distances up to the far bound of 10: relative 1e-4.
        np.testing.assert_allclose(tr_l["distance_mean"].numpy(), np.asarray(jr_l["distance_mean"]),
                                   rtol=1e-4, err_msg=msg)


def test_cone_field_mlp_matches():
    mlp_params = dict(NERF, skip_layer=2)
    j_mlp = JConeFieldMLP(warp="contract", **mlp_params)
    rng = np.random.RandomState(4)
    means = (rng.randn(5, 7, 3) * 2).astype(np.float32)
    a = rng.randn(5, 7, 3, 3).astype(np.float32) * 0.05
    covs = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    viewdirs = rng.randn(5, 3).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    j_vars = j_mlp.init(jax.random.PRNGKey(1), None, means, covs, viewdirs)
    t_mlp = TConeFieldMLP(warp="contract", **mlp_params)
    convert.params_from_flax(jax.device_get(j_vars), t_mlp)
    want = jax.jit(lambda v: j_mlp.apply(v, None, means, covs, viewdirs))(j_vars)
    with torch.no_grad():
        got = t_mlp(torch.from_numpy(means), torch.from_numpy(covs), torch.from_numpy(viewdirs))
    for key in ("density", "rgb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6)


def test_param_names_and_init_bounds():
    model = t_build("mipnerf360", **MODELS["flagship_options"])
    names = {n.rsplit(".", 1)[0] for n, _ in model.named_parameters()}
    assert {"nerf_mlp.trunk0", "nerf_mlp.density_head", "nerf_mlp.bottleneck", "nerf_mlp.view0",
            "nerf_mlp.rgb_head", "prop_mlp.trunk1", "prop_mlp.density_head"} <= names
    for n, p in model.named_parameters():
        if n.endswith("bias"):
            assert torch.all(p == 0), n
        else:  # He-uniform: |w| <= sqrt(6 / fan_in)
            assert p.abs().max() <= np.sqrt(6.0 / p.shape[1]) + 1e-7, n


def test_params_from_flax_rejects_mismatch():
    params = MODELS["flagship_options"]
    tree = jax.device_get(_init(j_build("mipnerf360", **params)))
    extra = {"params": dict(tree["params"], glo={"embedding": np.zeros((3, 2), np.float32)})}
    with pytest.raises(ValueError):
        convert.params_from_flax(extra, t_build("mipnerf360", **params))
    fewer = {"params": {"nerf_mlp": tree["params"]["nerf_mlp"]}}
    with pytest.raises(ValueError):
        convert.params_from_flax(fewer, t_build("mipnerf360", **params))
    wider = dict(params, nerf_mlp_params=dict(NERF, net_width=24))
    with pytest.raises(ValueError):
        convert.params_from_flax(tree, t_build("mipnerf360", **wider))
