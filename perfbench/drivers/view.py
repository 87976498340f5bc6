"""Traffic driver of one viewer: orbit views of a model the port just trained.

Set-up builds the dataset (`scene_load_s`), trains `warmup_train_steps`
steps through the port's `train/loop.py:train` and keeps the model it
returns (the occupancy grid rides in it), then renders `warmup_views`
views. The train steps are followed (`common.FirstSteps`): the output
check trains the plain reference from the seed on the same batches, and
renders the sampled views again from the state the program handed the
viewer (`reference/view_check.py`). In the window one user asks for a view, waits for its colour and
depth to reach the host (`tools/viewer.py:view_batch` rays through
`train/step.py:render_image`, in chunks of the configuration's
`render_chunk_size`, with its `ngp_eval_renderer`), and asks for the next:
a closed loop. Each view's latency runs from the request to the arrival.
The orbit poses are a fixed pool (`pose_pool` of them, drawn from
`pool_seed`): each around a train camera drawn at random, centred some
metres ahead of it, turned and tilted a little, so every view looks along
the road from inside the span of the train cameras. The run's seed orders
them: the window walks through one seeded permutation of the pool after
another, so every seed asks for the same views in another order.
"""

from __future__ import annotations

import dataclasses
import math
import shutil
import tempfile
import time

import numpy as np

from perfbench import scene as scene_lib
from perfbench import stats
from perfbench.drivers import common
from perfbench.harness import Measured
from perfbench.reference import data as data_ref


def orbit_params(rng, c2ws, scale: float, traffic: dict):
    """(center, radius, theta, phi) of one orbit view (viewer conventions:
    position = center + radius (cos phi sin theta, cos phi cos theta, sin phi))."""
    k = int(rng.integers(len(c2ws)))
    lo, hi = traffic["orbit_lookahead_m"]
    radius = float(rng.uniform(lo, hi)) * scale
    pos, forward = c2ws[k, :3, 3].astype(np.float64), -c2ws[k, :3, 2].astype(np.float64)
    back = -forward / np.linalg.norm(forward)
    theta = math.atan2(back[0], back[1]) + float(rng.uniform(-1, 1)) * traffic["orbit_dtheta"]
    phi = math.asin(float(np.clip(back[2], -1, 1))) + float(rng.uniform(-1, 1)) * traffic["orbit_dphi"]
    return pos - radius * back, radius, theta, float(np.clip(phi, -1.5, 1.5))


def run(run) -> Measured:
    import torch

    from outdoor_nerf_depth_torch.tools import viewer
    from outdoor_nerf_depth_torch.train import loop
    from outdoor_nerf_depth_torch.train import step as step_lib

    traffic = common.traffic(run)
    params = common.scene_params(run)
    scene_dir = scene_lib.ensure_scene(run.cache_root, params)
    exp_dir = tempfile.mkdtemp(prefix="perfbench-exp-")
    n_train = traffic["warmup_train_steps"]
    config = common.program_config(run, scene_dir, exp_dir, print_every=n_train)
    on_card = run.device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    t0 = time.perf_counter()
    dataset = loop.build_dataset(config, "train")
    scene_load_s = time.perf_counter() - t0
    follow = common.FirstSteps(n_train)
    follow.install()
    try:
        model, _ = loop.train(config, device=run.device, log_fn=lambda line: None,
                              dataset=dataset, max_steps=n_train)
    finally:
        follow.remove()
        shutil.rmtree(exp_dir, ignore_errors=True)
    model.eval()
    scene = data_ref.Scene(scene_dir, params)
    pool_rng = np.random.default_rng(traffic["pool_seed"])
    pool = [orbit_params(pool_rng, scene.c2w, scene.scale, traffic)
            for _ in range(traffic["pose_pool"])]
    order = np.random.default_rng(run.seed)

    def requests():
        while True:
            yield from (pool[i] for i in order.permutation(len(pool)))

    views = requests()
    h, w = traffic["height"], traffic["width"]

    def render(orbit):
        cam = viewer.OrbitCamera(*orbit)
        out = step_lib.render_image(model, viewer.view_batch(dataset, cam, h, w),
                                    config.render_chunk_size, run.device, config.ngp_eval_renderer)
        return out["rgb"], out["distance_mean"]

    for orbit in pool[:traffic["warmup_views"]]:
        render(orbit)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer = None
    if run.trace:
        from perfbench.trace import Tracer

        tracer = Tracer(run.device)
        tracer.start()
    orbits, outputs, latencies = [], [], []
    t_window = time.perf_counter()
    while True:
        orbit = next(views)
        t_req = time.perf_counter()
        rgb, depth = render(orbit)
        t_done = time.perf_counter()
        orbits.append(orbit)
        outputs.append((rgb, depth))
        latencies.append(t_done - t_req)
        if (len(latencies) >= traffic["trace_views"] if run.trace
                else t_done - t_window >= run.seconds):
            break
    t_end = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = sum(1 for rgb, depth in outputs
                 if not (np.isfinite(rgb).all() and np.isfinite(depth).all()))
    state = {k: common.cpu_copy(v) for k, v in model.state_dict().items()}
    near, far = config.near * scene.scale, config.far * scene.scale
    del model, dataset

    n = len(latencies)
    pick = np.random.default_rng([run.seed, 1]).choice(n, size=min(traffic["check_views"], n),
                                                      replace=False)
    sample = [(orbits[i], outputs[i]) for i in sorted(pick)]
    program = dataclasses.asdict(config)

    def check():
        from perfbench.reference import view_check

        return view_check.check(program, run.seed, params, scene_dir, follow, state, sample,
                                (h, w), (near, far), config.render_chunk_size, run.device,
                                run.cell.config["limits"], control=run.control)

    seconds = t_end - t_window
    counters = {"views": n, "window_s": seconds, "scene_load_s": scene_load_s,
                "window_peak_bytes": window_peak}
    return Measured(
        end_to_end={"view_ms_p95": 1e3 * stats.percentile(latencies, 95),
                    "view_rays_per_s": n * h * w / seconds,
                    "setup_s": t_window - run.t_start},
        counters=counters, attempted=n, failed=failed, check=check,
        memory_peak_bytes=max(setup_peak, window_peak), trace=tracer.summary() if tracer else None,
    )
