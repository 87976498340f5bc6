"""The port's spans and counters (`utils/tracing.py`) on the CPU: off, a span
opens no profiler range and a count records nothing; under `torch.profiler`
the loop, the train step, the models and the renderer leave their spans in
the Chrome trace, nested as the program runs, and the NGP samples counter
equals a recount from the step's own stats and the renders' outputs."""

import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.utils import tracing

torch.set_num_threads(1)

MIP = ("configs/kitti_mipnerf360.json", [
    "dataset=synthetic", "batch_size=32", "lr_delay_steps=0", "render_chunk_size=64",
    'model_params={"num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 2, '
    '"nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8, '
    '"net_width_viewdirs": 8, "max_deg_point": 4}, '
    '"prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}'])
NGP_PARAMS = dict(scale=0.5, max_samples=8, n_candidates=32, grid_resolution=8, sample_budget=4,
                  field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                                    max_resolution=16, hidden_width=16, geo_features=7))
NGP = ("configs/kitti_ngp.json", [
    "dataset=synthetic", "batch_size=32", "occupancy_update_every=2",
    "occupancy_warmup_steps=2", "occupancy_cells_per_update=64", "render_chunk_size=40",
    "model_params=" + json.dumps(NGP_PARAMS)])
NERFPP_PARAMS = dict(cascade_samples=[6, 6], net_depth=2, net_width=16, pos_degrees=4,
                     view_degrees=2)
NERFPP = ("configs/kitti_nerfpp.json", [
    "dataset=synthetic", "batch_size=32", "render_chunk_size=64",
    "model_params=" + json.dumps(NERFPP_PARAMS)])
CONFIGS = {"mip": MIP, "ngp": NGP, "nerfpp": NERFPP}
# The span each model opens inside `step.forward`.
MODEL_SPAN = {"mip": "mip.mlp", "ngp": "ngp.march", "nerfpp": "nerfpp.fg"}
PHASES = ("loop.batch", "step.forward", "step.backward", "step.optimizer")


def _config(kind, tmp_path, *extra):
    path, overrides = CONFIGS[kind]
    return load_config(path, overrides + [f"exp_dir={tmp_path / kind}", "print_every=4",
                                          "checkpoint_every=100", *extra])


def _profiled(fn):
    """fn() under a CPU profiler: (its result, the Chrome trace's span events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"tracing-test-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        events = _spans_of(path)
    finally:
        os.remove(path)
    return out, events


def _spans_of(path):
    """(name, thread, start us, end us) of every user annotation of a Chrome trace, by start."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return sorted(((e["name"], e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda s: (s[2], -s[3]))


def _inside(spans, outer, name=None):
    """The spans on `outer`'s thread that lie within it, by start; only `name` if given."""
    _, tid, start, end = outer
    eps = 1e-3  # the trace's microseconds as floats
    return [s for s in spans if s is not outer and s[1] == tid and s[2] >= start - eps
            and s[3] <= end + eps and (name is None or s[0] == name)]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.fixture(autouse=True)
def _clear_record():
    tracing.reset()
    yield
    tracing.reset()


def test_without_a_profiler_a_span_opens_no_range_and_counts_stay_empty(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with tracing.span("loop.step"):
        with tracing.span("step.forward"):
            tracing.count("ngp.samples", torch.ones(4), 2.0)
            tracing.count("ngp.rays", 4)
    assert tracing.snapshot() == {"counters": {}, "spans": {}}


def test_off_a_span_is_one_shared_context():
    assert tracing.span("a") is tracing.span("b")


def test_a_new_stretch_of_recording_clears_the_record():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("first"):
            tracing.count("c", 2.0)
    with tracing.span("between"):  # no profiler: the stretch has ended
        pass
    assert tracing.snapshot()["counters"] == {"c": 2.0}  # read after the stretch, kept
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("second"):
            tracing.count("c", torch.tensor([1.0, 2.0]), 3.0)
    snap = tracing.snapshot()
    assert snap["counters"] == {"c": 9.0}
    assert set(snap["spans"]) == {"second"} and snap["spans"]["second"]["count"] == 1
    assert snap["spans"]["second"]["host_s"] > 0


def test_threads_recording_at_once_lose_no_update(monkeypatch):
    """Autograd's backward thread records beside the loop's: the record's lock
    keeps every span and count of many threads switching often."""
    monkeypatch.setattr(tracing, "_thread_records", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: contextlib.nullcontext())
    threads, per = 8, 500
    names = [f"step.s{i}" for i in range(per)]

    def work():
        for name in names:
            with tracing.span(name):
                tracing.count("ngp.rays", 1)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    snap = tracing.snapshot()
    assert {snap["spans"][name]["count"] for name in names} == {threads}
    assert snap["counters"]["ngp.rays"] == threads * per


@pytest.mark.parametrize("kind", ["mip", "ngp", "nerfpp"])
def test_every_trained_step_holds_its_phases_in_order(kind, tmp_path):
    config = _config(kind, tmp_path, "max_steps=6")
    _, spans = _profiled(lambda: t_loop.train(config, device="cpu", log_fn=lambda line: None))
    steps = _named(spans, "loop.step")
    assert len(steps) == 6
    for outer in steps:
        inner = _inside(spans, outer)
        firsts = [next(i for i, s in enumerate(inner) if s[0] == name) for name in PHASES]
        assert firsts == sorted(firsts), [s[0] for s in inner]
        batch = _inside(spans, _named(inner, "loop.batch")[0])
        assert [s[0] for s in batch] == ["loop.batch.wait", "loop.batch.copy"]
        assert _inside(spans, _named(inner, "step.forward")[0], MODEL_SPAN[kind])
    if kind == "mip":  # one resampling and one MLP a level
        forward = _named(spans, "step.forward")[0]
        assert len(_inside(spans, forward, "mip.resample")) == 2
        assert len(_inside(spans, forward, "mip.mlp")) == 2
    if kind == "nerfpp":  # each level draws, then renders its foreground and background
        for forward in _named(spans, "step.forward"):
            names = [s[0] for s in _inside(spans, forward) if s[0].startswith("nerfpp.")]
            assert names == ["nerfpp.sample", "nerfpp.fg", "nerfpp.bg"] * 2, names
    # The NGP refresh falls due before steps 0, 2 and 4, inside those steps.
    refreshes = [i for i, outer in enumerate(steps) if _inside(spans, outer, "loop.refresh")]
    assert refreshes == ([0, 2, 4] if kind == "ngp" else [])
    assert len(_named(spans, "loop.log")) == 2  # steps 4 and 6
    assert len(_named(spans, "loop.checkpoint")) == 1  # at max_steps
    snap = tracing.snapshot()
    assert snap["spans"]["loop.step"]["count"] == 6
    assert snap["spans"]["loop.batch"]["count"] == 6


def test_the_loops_profile_window_file_holds_the_spans(tmp_path):
    config = _config("ngp", tmp_path, "max_steps=6", "profile_start_step=2",
                     "profile_num_steps=2")
    t_loop.train(config, device="cpu", log_fn=lambda line: None)
    trace_dir = os.path.join(config.exp_dir, "trace")
    (name,) = os.listdir(trace_dir)
    spans = _spans_of(os.path.join(trace_dir, name))
    assert len(_named(spans, "loop.step")) == 2
    assert {"loop.refresh", "loop.batch.copy", "step.forward", "ngp.field", "step.optimizer"} <= {
        s[0] for s in spans}


def _ngp_model_and_batch(tmp_path, h=9, w=11):
    config = _config("ngp", tmp_path)
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    model.occupancy.fill_(1.0)
    g = torch.Generator().manual_seed(1)
    dirs = torch.nn.functional.normalize(torch.randn(h, w, 3, generator=g), dim=-1)
    rays = rays_lib.dummy_rays((h, w))
    rays = rays_lib.Rays(**{**{f: getattr(rays, f) for f in rays.__dataclass_fields__},
                            "directions": dirs, "viewdirs": dirs,
                            "near": torch.full((h, w, 1), 0.05), "far": torch.full((h, w, 1), 2.0)})
    return config, model, rays_lib.Batch(rays=rays, rgb=torch.zeros(h, w, 3))


@pytest.mark.parametrize("renderer", ["train", "iterative"])
def test_render_image_nests_a_chunk_span_a_chunk(renderer, tmp_path):
    config, model, batch = _ngp_model_and_batch(tmp_path)
    chunk = config.render_chunk_size
    out, spans = _profiled(lambda: t_step.render_image(model, batch, chunk, "cpu", renderer))
    (image,) = _named(spans, "render.image")
    chunks = _inside(spans, image, "render.chunk")
    assert len(chunks) == -(-9 * 11 // chunk) == 3
    for c in chunks:
        names = [s[0] for s in _inside(spans, c)]
        assert names[0] == "render.copy_in" and names[-1] == "render.copy_out"
        assert ("ngp.eval_round" if renderer == "iterative" else "ngp.field") in names
    assert _inside(spans, image, "render.assemble")
    counters = tracing.snapshot()["counters"]
    assert counters["ngp.rays"] == 9 * 11
    assert counters["ngp.samples"] == float(out["samples_per_ray"].sum())


def test_ngp_samples_counter_equals_the_steps_own_stats(tmp_path):
    config = _config("ngp", tmp_path)
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    model.occupancy.fill_(1.0)
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    dataset = t_loop.build_dataset(config, "train")
    train_step = t_step.make_train_step(config, model, optimizer, lr_fn,
                                        cameras=dataset.cameras_on("cpu"),
                                        camtype=dataset.camtype)
    gen = torch.Generator().manual_seed(2)

    def steps():
        return [train_step(dataset.sample_batch(), i, i / 10, gen) for i in range(3)]

    stats, spans = _profiled(steps)
    counters = tracing.snapshot()["counters"]
    n = config.batch_size
    assert counters["ngp.rays"] == 3 * n
    recount = sum(float(s["vr_s"]) * n for s in stats)
    np.testing.assert_allclose(counters["ngp.samples"], recount, rtol=1e-6)
    assert 0 < counters["ngp.samples"] / counters["ngp.rays"] <= NGP_PARAMS["max_samples"]
    assert len(_named(spans, "step.forward")) == len(_named(spans, "step.optimizer")) == 3


def test_hash_grid_counts_the_levels_of_each_forward(tmp_path):
    """`hashgrid.fwd_levels` adds the grid's levels for every osplit forward
    of the NGP train path: one a step, one a chunk of an occupancy refresh."""
    config = _config("ngp", tmp_path)
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    model.occupancy.fill_(1.0)
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    dataset = t_loop.build_dataset(config, "train")
    train_step = t_step.make_train_step(config, model, optimizer, lr_fn,
                                        cameras=dataset.cameras_on("cpu"),
                                        camtype=dataset.camtype)
    update = t_step.make_occupancy_update_fn(config, model)
    gen = torch.Generator().manual_seed(2)

    def work():
        update(model.occupancy, gen, True)
        return [train_step(dataset.sample_batch(), i, i / 10, gen) for i in range(2)]

    _profiled(work)
    levels = NGP_PARAMS["field_params"]["n_levels"]
    refresh_chunks = -(-model.occupancy.numel() // 131_072)  # ops/occupancy.py:update_grid
    assert tracing.snapshot()["counters"]["hashgrid.fwd_levels"] == (2 + refresh_chunks) * levels


def _nerfpp_rays(n: int):
    """n rays from inside the unit sphere, seeded."""
    g = torch.Generator().manual_seed(5)
    origins = 0.3 * (torch.rand(n, 3, generator=g) - 0.5)
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    rays = rays_lib.dummy_rays((n,))
    return rays_lib.Rays(**{**{f: getattr(rays, f) for f in rays.__dataclass_fields__},
                            "origins": origins, "directions": dirs, "viewdirs": dirs,
                            "near": torch.full((n, 1), 1e-4), "far": torch.full((n, 1), 2.0)})


@pytest.mark.parametrize("cascade,per_ray", [((64, 128), 512), ((6, 6), 36), ((5, 3, 2), 46)])
def test_nerfpp_counters_read_the_cascades_points_a_ray(cascade, per_ray):
    """Each level evaluates its samples, all earlier ones merged in, in the
    foreground and the background field: 2 x (64 + 192) at the config's (64, 128)."""
    from outdoor_nerf_depth_torch.models.nerfpp import InvertedSphereModel

    model = InvertedSphereModel(cascade_samples=cascade, net_depth=2, net_width=16,
                                pos_degrees=4, view_degrees=2,
                                generator=torch.Generator().manual_seed(0))
    n = 6
    _, spans = _profiled(lambda: model(_nerfpp_rays(n), generator=torch.Generator().manual_seed(1)))
    counters = tracing.snapshot()["counters"]
    assert counters["nerfpp.rays"] == n
    assert counters["nerfpp.points"] / counters["nerfpp.rays"] == per_ray
    assert [s[0] for s in spans] == ["nerfpp.sample", "nerfpp.fg", "nerfpp.bg"] * len(cascade)


def _nerfpp_step_readings(tmp_path, profiled: bool):
    """One seeded NeRF++ train step on the CPU: its loss, the gradients the
    optimizer got, the parameters after it and the aten ops it dispatched."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace != "profiler":  # record_function's own ops
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    config = _config("nerfpp", tmp_path)
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    dataset = t_loop.build_dataset(config, "train")
    train_step = t_step.make_train_step(config, model, optimizer, lr_fn,
                                        cameras=dataset.cameras_on("cpu"),
                                        camtype=dataset.camtype)
    batch = dataset.sample_batch()
    counter = OpCount()

    def step():
        with counter:
            return train_step(batch, 0, 0.0, torch.Generator().manual_seed(2))

    stats = _profiled(step)[0] if profiled else step()
    return (float(stats["loss"]), {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: p.detach().clone() for k, p in model.named_parameters()}, counter.ops)


def test_a_nerfpp_step_is_the_same_with_a_profiler_recording(tmp_path):
    loss, grads, params, ops = _nerfpp_step_readings(tmp_path, profiled=False)
    assert tracing.snapshot() == {"counters": {}, "spans": {}}
    loss_p, grads_p, params_p, ops_p = _nerfpp_step_readings(tmp_path, profiled=True)
    assert "nerfpp.fg" in tracing.snapshot()["spans"]
    assert loss_p == loss and ops_p == ops and len(ops) > 100
    for k in grads:
        assert torch.equal(grads_p[k], grads[k]), k
        assert torch.equal(params_p[k], params[k]), k
