"""`remat` (none, dots, full) of the port's train step on the CPU: the
checkpointed forward gives the same stats and parameters as the plain one,
with randomized sampling drawn from an explicit generator that ends where
the plain step leaves it (the recompute replays the forward's draws), for
the mip-NeRF 360 and Instant-NGP models (NGP with and without a sample
budget); "dots" keeps the matmul outputs, so its backward recomputes no
matmul, where "full" recomputes them all. The reference's counterpart is
its remat test, which holds one step's loss and gradient norm."""

import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.ops import volren_weights
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config

torch.set_num_threads(1)

MIP = ["configs/kitti_mipnerf360.json",
       'model_params={"num_prop_samples": 16, "num_nerf_samples": 8, "num_levels": 3, '
       '"raydist_fn": "reciprocal", "opaque_background": true, "single_jitter": true, '
       '"bg_intensity_range": [0.0, 1.0], '
       '"nerf_mlp_params": {"net_depth": 3, "net_width": 32, "bottleneck_width": 16, '
       '"net_width_viewdirs": 16, "max_deg_point": 4}, '
       '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}']
NGP_MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16,
                 field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                                   max_resolution=16, hidden_width=16, geo_features=7))
CASES = {
    "mip": MIP,
    "ngp_budget": ["configs/kitti_ngp.json",
                   "model_params=" + json.dumps(dict(NGP_MODEL, sample_budget=8))],
    # Budget 0: the field runs on every slot of every ray.
    "ngp_no_budget": ["configs/kitti_ngp.json",
                      "model_params=" + json.dumps(dict(NGP_MODEL, sample_budget=0))],
}
COMMON = ["dataset=synthetic", "batch_size=32", "max_steps=4", "lr_delay_steps=0",
          "randomized=true", "exp_dir=unused"]
STEPS = 2


def _setup(case, remat):
    path, model_params = CASES[case]
    config = load_config(path, COMMON + [model_params, f"remat={remat}"])
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    if model.__class__.__name__ == "HashGridModel":
        grid = torch.rand(model.occupancy.shape, generator=torch.Generator().manual_seed(1))
        model.occupancy.copy_(torch.where(grid < 0.5, 0.0, 2.0 * grid))
    dataset = t_datasets.SyntheticDataset("train", global_batch_size=32, n_images=4,
                                          height=12, width=16, seed=3)
    return config, model, dataset


def _run(case, remat):
    config, model, dataset = _setup(case, remat)
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    step = t_step.make_train_step(config, model, optimizer, lr_fn,
                                  cameras=dataset.cameras_on("cpu"), camtype=dataset.camtype)
    gen = torch.Generator().manual_seed(5)
    stats = [step(dataset.sample_batch(), i, 0.3 + 0.1 * i, gen) for i in range(STEPS)]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return stats, params, gen.get_state()


@pytest.fixture(scope="module")
def runs():
    return {(case, remat): _run(case, remat) for case in CASES
            for remat in ("none", "dots", "full")}


def _close(a, b, rtol, atol=0.0):
    return torch.allclose(torch.as_tensor(a), torch.as_tensor(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_matches_no_remat(runs, case, remat):
    stats, params, gen_state = runs[(case, remat)]
    base_stats, base_params, base_gen = runs[(case, "none")]
    for s, b in zip(stats, base_stats):
        assert set(s["loss_terms"]) == set(b["loss_terms"])
        for k in b["loss_terms"]:
            assert _close(s["loss_terms"][k], b["loss_terms"][k], 1e-5, 1e-9), k
        for k in ("loss", "psnr", "grad_norm"):
            assert _close(s[k], b[k], 1e-5), k
    for name, p in base_params.items():
        assert _close(params[name], p, 1e-4, 1e-7), name
    # The recompute drew the forward's jitter again, and the generator ends
    # where the plain steps leave it.
    assert torch.equal(gen_state, base_gen)


def test_remat_changes_the_generator_like_no_remat(runs):
    """The draws matter here: without a generator restore the stats would
    differ, so equal stats above are not an accident of a draw-free path."""
    _, _, gen_state = runs[("mip", "none")]
    assert not torch.equal(gen_state, torch.Generator().manual_seed(5).get_state())


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(case, remat):
    """mm/addmm calls the backward of one forward + loss makes."""
    config, model, dataset = _setup(case, remat)
    batch = dataset.sample_batch()
    rays = t_cameras.cast_pixels(batch.rays, dataset.cameras_on("cpu"), dataset.camtype)
    forward = t_step.make_forward(config, model, compute_extras=True)
    renderings, history = forward(rays, 0.5, torch.Generator().manual_seed(2))
    loss_terms, _ = t_step._total_loss(config, batch, renderings, history, rays)
    with _CountMatmuls() as count:
        sum(loss_terms.values()).backward()
    return count.n


@pytest.mark.parametrize("case", ["mip", "ngp_budget"])
def test_dots_saves_the_matmul_outputs(case):
    base = _backward_matmuls(case, "none")
    assert base > 0
    # "dots": only the gradients' own products; "full": the forward's again.
    assert _backward_matmuls(case, "dots") == base
    assert _backward_matmuls(case, "full") > base


def test_remat_recomputes_the_compositing_kernel_forward(monkeypatch):
    """Under remat the forward of the compositing weights (K1a on the card)
    runs again in the backward: twice per level, once per level without."""
    calls = []
    real = volren_weights.weights_from_tau_plain
    monkeypatch.setattr(volren_weights, "weights_from_tau_plain",
                        lambda tau: calls.append(tau.shape) or real(tau))
    counts = {}
    for remat in ("none", "dots"):
        config, model, dataset = _setup("mip", remat)
        optimizer, lr_fn = t_step.make_optimizer(config, model)
        step = t_step.make_train_step(config, model, optimizer, lr_fn,
                                      cameras=dataset.cameras_on("cpu"), camtype=dataset.camtype)
        calls.clear()
        step(dataset.sample_batch(), 0, 0.5, torch.Generator().manual_seed(0))
        counts[remat] = len(calls)
    assert counts == {"none": 3, "dots": 6}


def test_unknown_remat_raises():
    with pytest.raises(ValueError):
        t_step.check_supported(load_config(MIP[0], COMMON + ["remat=some"]))
