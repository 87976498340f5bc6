"""The bench operating points and the probes built on them, against the
reference's scripts on the CPU: `workloads.ngp_bench_config` and
`nerfpp_bench_config` equal, field by field, the configs that `bench.py`'s
`_ngp_setup`, `benchmarks/ngp_step.py` and the three NeRF++ probes build
(captured by a stand-in for the reference's `init_state`); the ablations
equal the reference's; the stages of `probes/ngp_bwd`, composed, give
`OctEncode.backward`'s table gradient exactly; `probes/ngp_eval`'s shell
scene rendered by both renderers agrees with the reference's renders of the
same scene (1e-5 iterative, 2e-5 dense) and the two renderers with each
other (mean |difference| below 0.02); each probe's `run(device="cpu")` at
tiny sizes returns its keys, the NeRF++ probes with no kernel launched."""

import dataclasses
import importlib.util
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.probes import (nerfpp_ablate, nerfpp_mfu, ngp_bwd, ngp_eval,
                                             ngp_layout, ngp_step, profile_step, workloads)
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_tpu import parallel
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.train import step as j_step
from outdoor_nerf_depth_tpu.train.config import Config as JConfig

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIELD = dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
             hidden_width=16, geo_features=7)
TINY_NGP = dict(grid_resolution=16, field_params=FIELD)
TINY_NERFPP = dict(cascade_samples=(6, 6), net_depth=2, net_width=16, pos_degrees=4,
                   view_degrees=2)
ITERATIVE_TOL = 1e-5  # tests/test_torch_ngp_eval.py's render_eval tolerance
DENSE_ATOL, DENSE_RTOL = 2e-5, 1e-5  # tests/test_torch_ngp.py's render_image tolerance
RENDERERS_MEAN_TOL = 0.02  # chip_smoke.py's NGP_EVAL_MEAN_TOL


class _Captured(Exception):
    pass


@pytest.fixture
def capture(monkeypatch):
    """The Config the reference script hands to `init_state`, which then stops it."""
    seen = []

    def init_state(config, rng):
        seen.append(config)
        raise _Captured

    monkeypatch.setattr(j_step, "init_state", init_state)

    def run(fn, *args):
        with pytest.raises(_Captured):
            fn(*args)
        return seen.pop()

    return run


def _script(*parts):
    path = REPO.joinpath(*parts)
    spec = importlib.util.spec_from_file_location(f"root_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fields_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


@pytest.mark.parametrize("batch,max_samples", [(8192, 64), (32768, 64), (4096, 32)])
def test_ngp_bench_config_equals_bench_ngp_setup(capture, batch, max_samples):
    import bench

    want = capture(bench._ngp_setup, batch, max_samples)
    _fields_equal(workloads.ngp_bench_config(batch, max_samples), want)


def test_ngp_bench_config_equals_ngp_step_scripts(capture):
    want = capture(_script("benchmarks", "ngp_step.py").main, [])
    _fields_equal(workloads.ngp_bench_config(8192, 64), want)


@pytest.mark.parametrize("batch,k", [(1024, 8), (4096, 32)])
def test_nerfpp_bench_config_equals_the_mfu_probe(capture, batch, k):
    want = capture(_script("benchmarks", "probes", "nerfpp_mfu_probe.py").measure, batch, k)
    _fields_equal(workloads.nerfpp_bench_config(batch), want)


@pytest.mark.parametrize("tag", [tag for tag, _, _ in nerfpp_ablate.ABLATIONS])
def test_ablations_equal_the_reference(capture, tag):
    reference = _script("benchmarks", "probes", "nerfpp_ablate_probe.py")
    assert nerfpp_ablate.ABLATIONS == tuple(reference.ABLATIONS)
    _, model_ov, config_ov = dict((t, (t, m, c)) for t, m, c in reference.ABLATIONS)[tag]
    want = capture(reference.measure, tag, model_ov, config_ov)
    _fields_equal(workloads.nerfpp_bench_config(nerfpp_ablate.BATCH, model_ov, config_ov), want)
    assert (nerfpp_ablate.BATCH, nerfpp_ablate.K) == (1024, 8)


def test_nerfpp_bench_config_equals_profile_step(capture):
    want = capture(_script("benchmarks", "probes", "profile_step.py").main)
    _fields_equal(workloads.nerfpp_bench_config(profile_step.BATCH), want)
    assert (profile_step.BATCH, profile_step.K) == (1024, 8)


@pytest.mark.parametrize("samples,log2t", [(300, 8), (1000, 10)])
def test_ngp_bwd_stages_compose_to_the_backward(samples, log2t):
    """The probe's timed stages, each run on the previous one's output,
    give the table gradient of `OctEncode.backward` through autograd."""
    results = ngp_bwd.run("cpu", samples=samples, log2_table_size=log2t, reps=1, seed=samples)
    assert results["composed_vs_backward_max_abs"] == 0.0
    assert results["backward_max_abs"] > 0


def test_ngp_bwd_probe_on_cpu():
    results = ngp_bwd.run("cpu", samples=256, log2_table_size=9, reps=1)
    stages = ("build_oct", "rowgather", "trilerp", "idxw", "vals", "sort1", "vgather", "scan",
              "cumsum", "cumsum_T", "sentinel_sort", "segment_ends", "fgather", "fold", "dx",
              "scatter_unsorted", "scatter_sorted", "bwd_bf16", "bwd_factored",
              "bwd_transposed", "full_bwd")
    for name in stages:
        assert results[f"{name}_s"] > 0 and math.isfinite(results[f"{name}_s"]), name
        assert results["launches"][name] == {"calls": 2, "launches": 0}, name
    assert results["composed_vs_backward_max_abs"] == 0.0
    assert results["m"] == 256 * ngp_bwd.LEVELS and results["kind"] == "cpu"


@pytest.fixture(scope="module")
def shell_renders():
    """The probe's shell scene in float32 on tiny widths, rendered by the
    port's and the reference's iterative and dense renderers from the same
    Flax weights."""
    chunk = 300
    config_t = workloads.ngp_bench_config(chunk, 16, compute_dtype="float32", **TINY_NGP)
    config_j = JConfig(**dataclasses.asdict(config_t))
    model_j = j_step.build_model(config_j)
    variables = jax.device_get(model_j.init(jax.random.PRNGKey(0), rng=None,
                                            rays=j_rays.dummy_rays((8,)), train_frac=1.0,
                                            compute_extras=False))
    model_t = ngp_eval.make_shell(convert.params_from_flax(variables,
                                                           t_step.build_model(config_t)))
    bias = np.array(variables["params"]["field"]["sigma_out"]["bias"])
    bias[0] += ngp_eval.SIGMA_BIAS
    variables["params"]["field"]["sigma_out"]["bias"] = bias
    grid = ngp_eval.shell_grid(model_t.scale, model_t.grid_resolution).numpy()
    assert 0 < grid.sum() < grid.size

    dataset_t, _ = workloads.bench_scene(chunk, "cpu", n_batches=0)
    batch_t = ngp_eval.tiled_view(dataset_t, chunk)
    view = j_datasets.SyntheticDataset("train", global_batch_size=chunk, n_images=8, height=94,
                                       width=310, seed=0).image_batch(0).rays
    rays_j = jax.tree_util.tree_map(lambda r: np.asarray(r).reshape((-1,) + r.shape[2:])[:chunk]
                                    [None], view)
    np.testing.assert_array_equal(batch_t.rays.origins.numpy(), rays_j.origins)
    mesh = parallel.make_mesh(jax.devices()[:1])
    out = {}
    for mode in ngp_eval.MODES:
        with jax.default_matmul_precision("highest"):
            fn = j_step.make_render_fn(config_j.replace(ngp_eval_renderer=mode), model_j, mesh)
            want = j_step.render_image(fn, variables, j_rays.Batch(rays=rays_j), mesh, chunk,
                                       aux=jnp.asarray(grid))
        got = t_step.render_image(model_t, batch_t, chunk, "cpu", mode)
        out[mode] = ({k: np.asarray(v) for k, v in want.items()}, got)
    return out


@pytest.mark.parametrize("mode", ngp_eval.MODES)
def test_ngp_eval_renders_match_the_reference(shell_renders, mode):
    want, got = shell_renders[mode]
    atol, rtol = (ITERATIVE_TOL, ITERATIVE_TOL) if mode == "iterative" else (DENSE_ATOL,
                                                                              DENSE_RTOL)
    for key in ("rgb", "depth", "distance_mean", "acc"):
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=rtol, err_msg=key)
    assert np.mean(got["acc"]) > 0.5  # the shell is hit and opaque


def test_ngp_eval_renderers_agree_on_the_shell(shell_renders):
    iterative, dense = shell_renders["iterative"][1], shell_renders["train"][1]
    for key in ("rgb", "acc"):
        assert np.mean(np.abs(iterative[key] - dense[key])) < RENDERERS_MEAN_TOL, key
    assert np.all(iterative["rounds"] >= 1)


def test_ngp_eval_probe_on_cpu():
    results = ngp_eval.run("cpu", chunks=(256, 512), reps=1, max_samples=16, **TINY_NGP)
    for chunk in (256, 512):
        entry = results[f"chunk_{chunk}"]
        assert entry["iterative"] > 0 and entry["train"] > 0
        assert entry["speedup_iter_vs_dense"] == entry["iterative"] / entry["train"]
        assert entry["launches"] == {m: {"calls": 2, "launches": 0} for m in ngp_eval.MODES}


def test_ngp_step_probe_on_cpu(tmp_path):
    result = ngp_step.run("cpu", batch=64, max_samples=16, steps=3, **TINY_NGP)
    assert result["metric"] == "ngp_rays_per_sec" and result["unit"] == "rays/s"
    assert result["value"] == 64 * 3 / result["seconds"] > 0
    assert (result["batch"], result["max_samples"], result["steps"], result["refreshes"]) == (
        64, 16, 3, 1)
    assert set(result["launches"].values()) == {0} and result["nvidia_smi"] is None


def test_ngp_layout_full_step_takes_the_bench_config(monkeypatch):
    seen = []
    real = workloads.bench_trainer
    monkeypatch.setattr(workloads, "bench_trainer",
                        lambda config, device, **kw: seen.append(config) or real(config, device,
                                                                                 **kw))
    ngp_layout.bench_full_step("oct", torch.device("cpu"), batch=64, reps=1, log2_table_size=10,
                               grid_resolution=16)
    _fields_equal(seen[0], workloads.ngp_bench_config(
        64, hash_layout="oct", grid_resolution=16, field_params={"log2_table_size": 10}))


def test_nerfpp_mfu_probe_on_cpu():
    results = nerfpp_mfu.run("cpu", sweep=((32, 2), (64, 3)), n_meas=2, **TINY_NERFPP)
    assert [(r["batch"], r["k"]) for r in results["sweep"]] == [(32, 2), (64, 3)]
    for r in results["sweep"]:
        assert len(r["dispatch_s"]) == 2 and r["rays_per_sec"] > 0 and r["mfu_pct"] > 0
        assert r["step_ms"] == pytest.approx(1e3 / r["steps_per_sec"])
        assert set(r["launches"].values()) == {0}
    assert results["peak_bf16_tflops"] == 989.0 and nerfpp_mfu.SWEEP == (
        (1024, 8), (1024, 32), (1024, 128), (4096, 8), (4096, 32))


def test_nerfpp_flops_count_the_linear_layers():
    config = workloads.nerfpp_bench_config(16, TINY_NERFPP)
    model = t_step.build_model(config)
    per_point = sum(2 * m.in_features * m.out_features for field in ("fg_field", "bg_field")
                    for m in getattr(model.level0, field).modules()
                    if isinstance(m, torch.nn.Linear))
    # The levels' fields have one shape; level 0 runs on 6 samples, level 1 on 12.
    assert nerfpp_mfu.forward_flops(model, 16) == 16 * per_point * (6 + 12)


def test_nerfpp_ablate_probe_on_cpu():
    results = nerfpp_ablate.run("cpu", tags=["base", "coarse0", "nodepth"], n_meas=1, batch=32,
                                k=2, net_depth=2, net_width=16, pos_degrees=4, view_degrees=2)
    assert [r["tag"] for r in results["ablations"]] == ["base", "coarse0", "nodepth"]
    for r in results["ablations"]:
        assert r["step_ms"] > 0 and r["rays_per_sec"] > 0 and set(r["launches"].values()) == {0}


def test_profile_step_probe_on_cpu(tmp_path):
    results = profile_step.run("cpu", trace_dir=str(tmp_path / "trace"), top=5, batch=32, k=2,
                               **TINY_NERFPP)
    assert results["rays_per_sec"] > 0 and len(results["top_ops"]) == 5
    assert results["ranked_by"] == "self_cpu_time_total"
    assert sum(op["share"] for op in results["top_ops"]) <= 1.0 + 1e-9
    assert set(results["launches"].values()) == {0}
    trace = json.loads(pathlib.Path(results["trace"]).read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("module", [ngp_step, ngp_bwd, ngp_eval, nerfpp_mfu, nerfpp_ablate,
                                    profile_step])
def test_probes_default_to_cuda(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run()


def test_probes_read_no_reference_switch():
    for module in (ngp_step, ngp_bwd, ngp_eval, nerfpp_mfu, nerfpp_ablate, profile_step,
                   workloads):
        text = pathlib.Path(module.__file__).read_text()
        assert "ONDT_" not in text and "environ" not in text, module.__name__
