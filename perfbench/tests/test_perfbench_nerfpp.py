"""The NeRF++ cell on the CPU at tiny sizes: a whole run is correct and each
planted fault turns it false; the plain reference agrees with the port's
`InvertedSphereModel` on seeded weights and the same draws; the scene in
the NeRF++ layout reads back through the port's reader ray for ray; the
FLOPs count equals one from the port's layer shapes."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from perfbench import flops_nerfpp, harness, scene_nerfpp
from perfbench.drivers.train_nerfpp import pixel_batch_to_cpu
from perfbench.reference import nerfpp as nerfpp_ref
from perfbench.reference import nerfpp_check
from perfbench.tests import _tiny
from perfbench.tests.test_perfbench_cpu_runs import _half_batch, _unchanged_step

CELL = "nerfpp_kitti.train"
TINY_MODEL = {"cascade_samples": [6, 6], "net_depth": 2, "net_width": 16, "pos_degrees": 4,
              "view_degrees": 2}
TINY = {"model_params": TINY_MODEL, "batch_size": 64}
PUBLISHED = harness.load_cell(CELL).config["program"]["model_params"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench-nerfpp-cache")


@pytest.fixture(scope="module")
def scene_dir(cache):
    params = dict(json.load(open(f"{harness.ROOT}/perfbench/scenes/kitti_drive.json")),
                  **_tiny.SCENE)
    return scene_nerfpp.ensure_scene(str(cache), {k: v for k, v in params.items()
                                                  if not k.startswith("_")})


def tiny_run(cache, trace=False):
    cell = harness.load_cell(CELL)
    return harness.Run(cell, 3_000_000_019, 1.0, trace, "cpu", time.perf_counter(),
                       cache_root=str(cache), program_overrides=TINY,
                       scene_overrides=_tiny.SCENE, traffic_overrides=_tiny.TRAFFIC["train"])


def test_sound_run_is_correct(cache):
    result = harness.execute(tiny_run(cache))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(CELL).end_to_end}
    assert result["checks"]["batch_rays_off"]["value"] == 0.0
    assert result["checks"]["init_gap"]["value"] == 0.0


def test_traced_run_reports_the_cells_per_layer_metrics(cache):
    result = harness.execute(tiny_run(cache, trace=True))
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert {"scene_load_s", "nerfpp_mfu_pct", "data_wait_ms_per_step.host_paced"} <= set(metrics)
    assert [k for k in metrics if k.startswith("field_ms_per_step")]
    assert 0 < metrics["nerfpp_mfu_pct"]["value"]
    assert not {"mfu_pct.host_paced", "volren_weights_roofline"} & set(metrics)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch], ids=lambda f: f.__name__)
def test_fault_turns_correct_false(fault, cache, monkeypatch):
    fault(monkeypatch)
    result = harness.execute(tiny_run(cache))
    assert not result["correct"], result["checks"]


def _port_batch(scene_dir, n=48):
    from outdoor_nerf_depth_torch.data import cameras as cameras_lib
    from outdoor_nerf_depth_torch.data import datasets

    dataset = datasets.NerfppSceneDataset(scene_dir, "train", n)
    batch = dataset.sample_batch()  # pixels: the camera of each is cast in the step
    return dataset, batch, cameras_lib.cast_pixels(batch.rays, dataset.cameras_on("cpu"))


def test_scene_reads_back_through_the_ports_reader(scene_dir):
    dataset, batch, rays = _port_batch(scene_dir)
    scene = nerfpp_check.Scene(scene_dir)
    assert dataset.n_images == len(scene.stems) == 18  # 20 views, 9 and 19 held out
    centres = np.linalg.norm(scene.c2w[:, :3, 3], axis=-1)
    assert centres.max() <= 1 / 1.1 + 1e-6
    record = pixel_batch_to_cpu(batch)
    assert nerfpp_check.batch_errors(scene, record) == 0
    ref = nerfpp_check.reference_batch(scene, record, "cpu")
    np.testing.assert_allclose(ref["directions"], rays.directions, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ref["origins"], rays.origins)
    np.testing.assert_array_equal(ref["near"], rays.near)
    # A colour, a depth or a bound not the layout's counts as a wrong ray.
    for field in ("rgb", "depth_sup", "near"):
        wrong = dict(record, **{field: record[field].clone()})
        wrong[field][3] += 0.25
        assert nerfpp_check.batch_errors(scene, wrong) == 1, field


def test_reference_agrees_with_the_port_model(scene_dir):
    """Seeded weights and the same draws: the forward, the loss and the
    step-0 gradients of the port's `InvertedSphereModel` and its loss terms."""
    from outdoor_nerf_depth_torch.data import rays as rays_lib
    from outdoor_nerf_depth_torch.train import step as step_lib
    from outdoor_nerf_depth_torch.train.config import Config

    seed = 3_000_000_019
    program = dict(harness.load_cell(CELL).config["program"], **TINY)
    config = Config().replace(**program)
    model = step_lib.build_model(config, generator=torch.Generator().manual_seed(seed))
    init = nerfpp_ref.init_params(TINY_MODEL, seed)
    named = dict(model.named_parameters())
    assert set(named) == set(init)
    for k, v in init.items():
        assert torch.equal(named[k].detach(), v), k

    _, batch, rays = _port_batch(scene_dir)
    record = pixel_batch_to_cpu(batch)
    scene = nerfpp_check.Scene(scene_dir)
    b = nerfpp_check.reference_batch(scene, record, "cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    ref_renders = nerfpp_ref.render(params, TINY_MODEL, b, torch.Generator().manual_seed(7))
    ref_loss = nerfpp_ref.loss(dataclasses.asdict(config), b, ref_renders)
    ref_grads = torch.autograd.grad(ref_loss, list(params.values()))

    renders, history = model(rays, generator=torch.Generator().manual_seed(7))
    port = rays_lib.Batch(rays=rays, rgb=batch.rgb, depth_gt=batch.depth_gt,
                          depth_sup=batch.depth_sup)
    terms, _ = step_lib._total_loss(config, port, renders, history, rays)
    loss = sum(terms.values())
    loss.backward()
    for mine, theirs in zip(renders, ref_renders):
        for key in ("rgb", "depth", "fg_weights", "bg_weights"):
            np.testing.assert_allclose(mine[key].detach(), theirs[key].detach(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-6)
    for k, g in zip(params, ref_grads):
        scale = float(g.abs().max()) + 1e-12
        np.testing.assert_allclose(named[k].grad / scale, g / scale, atol=1e-5, err_msg=k)


def test_flops_count_equals_the_ports_layer_shapes():
    from outdoor_nerf_depth_torch.models.nerfpp import InvertedSphereModel

    model = InvertedSphereModel(**PUBLISHED)
    batch, total, samples = 1024, 0, 0
    for level, new in enumerate(PUBLISHED["cascade_samples"]):
        samples += new
        for kind in ("fg_field", "bg_field"):
            linears = [m for m in getattr(model, f"level{level}").get_submodule(kind).modules()
                       if isinstance(m, torch.nn.Linear)]
            fwd = sum(2 * batch * samples * m.in_features * m.out_features for m in linears)
            first = 2 * batch * samples * linears[0].in_features * linears[0].out_features
            total += 3 * fwd - first
    assert flops_nerfpp.nerfpp_train_flops(PUBLISHED, batch) == total
    assert abs(total / 1.864e12 - 1) < 1e-3
    assert flops_nerfpp.points_per_ray(PUBLISHED) == 512
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(2.40e6, rel=0.01)
