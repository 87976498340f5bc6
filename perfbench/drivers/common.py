"""What the drivers share: the program's configuration, the scene file,
and the capture of the first train steps for the output check."""

from __future__ import annotations

import dataclasses
import json
import os

from perfbench.reference.train_check import CHANGE_STEPS


def scene_params(run) -> dict:
    with open(os.path.join(run.root, "perfbench", "scenes", run.cell.config["scene"] + ".json")) as f:
        params = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
    params.update(run.scene_overrides or {})
    return params


def traffic(run) -> dict:
    return dict(run.cell.traffic, **(run.traffic_overrides or {}))


def program_config(run, scene_dir: str, exp_dir: str, **loop):
    """The port's Config of the cell: the configuration file's keys, the
    run's seed, the scene and the traffic's loop settings."""
    from outdoor_nerf_depth_torch.train.config import Config

    keys = dict(run.cell.config["program"])
    keys.update(run.program_overrides or {})
    return Config().replace(**keys, seed=run.seed, scene_dir=scene_dir, exp_dir=exp_dir, **loop)


def cpu_copy(t):
    return None if t is None else t.detach().to("cpu", copy=True)


def batch_to_cpu(batch) -> dict:
    """The fields of a train batch (rays already cast) as CPU tensors."""
    rays = batch.rays
    out = {k: cpu_copy(getattr(rays, k)) for k in
           ("origins", "directions", "viewdirs", "radii", "lossmult", "near", "far", "cam_idx")}
    out.update(rgb=cpu_copy(batch.rgb), depth_gt=cpu_copy(batch.depth_gt),
               depth_sup=cpu_copy(batch.depth_sup))
    return out


class FirstSteps:
    """Records what the output check needs of the first `n` train steps of
    the one model and optimizer the loop builds and then times: the
    initial parameters, each step's batch and loss, the gradients the
    optimizer got at step 0, the parameters after `CHANGE_STEPS` steps,
    and an NGP model's occupancy grid before step 0. Where `n` is larger,
    also the last followed step's parameters before it, its gradients, the
    grid it marched on (after the refresh that fell due at it) and the grid
    before that refresh.

    `install()` wraps the port's `make_train_step`, which `train` calls
    once; `remove()` puts it back and drops every reference to the
    program's objects."""

    def __init__(self, n: int):
        self.n = n
        self.init_params = None
        self.grid0 = self.grid_prev = self.grid_last = None
        self.batches, self.losses = [], []
        self.grads0 = self.grads_last = self.params_after = self.params_last = None
        self._model = None
        self._orig = None

    def install(self):
        from outdoor_nerf_depth_torch.train import step as step_lib

        self._step_lib = step_lib
        self._orig = step_lib.make_train_step
        step_lib.make_train_step = self._make

    def remove(self):
        if self._orig is not None:
            self._step_lib.make_train_step = self._orig
        self._model = None

    def _named(self):
        return {k: cpu_copy(p) for k, p in self._model.named_parameters()}

    def _grads(self):
        return {k: cpu_copy(p.grad) for k, p in self._model.named_parameters()}

    def _make(self, config, model, optimizer, lr_fn, **kwargs):
        step = self._orig(config, model, optimizer, lr_fn, **kwargs)
        self._model = model
        self.init_params = self._named()
        last = self.n - 1

        def first_steps(batch, step_index, train_frac, generator=None):
            if step_index > last or self._model is None:
                return step(batch, step_index, train_frac, generator)
            grid = getattr(model, "occupancy", None)
            if step_index == 0 and grid is not None:
                self.grid0 = cpu_copy(grid)
            if last >= CHANGE_STEPS and grid is not None:
                if step_index == last - 1:
                    self.grid_prev = cpu_copy(grid)
                if step_index == last:
                    self.grid_last = cpu_copy(grid)
            if step_index == last and last >= CHANGE_STEPS:
                self.params_last = self._named()
            self.batches.append(batch_to_cpu(batch))
            stats = step(batch, step_index, train_frac, generator)
            self.losses.append(float(stats["loss"]))
            if step_index == 0:
                self.grads0 = self._grads()
            if step_index == min(self.n, CHANGE_STEPS) - 1:
                self.params_after = self._named()
            if step_index == last:
                if last >= CHANGE_STEPS:
                    self.grads_last = self._grads()
                self._model = None
            return stats

        return first_steps


def train_measured(run, window, follow: FirstSteps, config, scene_params: dict, scene_dir: str,
                   *, scene_load_s: float, memory_peak: int, trace):
    """The `Measured` of a train window (`drivers.train.Window`): the rate
    over the window's rays and time, the counters the per-layer readers
    read, and the output check."""
    from perfbench.harness import Measured

    program = dataclasses.asdict(config)
    steps, seconds = window.step1 - window.step0, window.t1 - window.t0
    counters = {
        "steps": steps, "rays": steps * config.batch_size, "window_s": seconds,
        "scene_load_s": scene_load_s, "batch_size": config.batch_size,
        "model_params": program["model_params"], "model": config.model,
        "precision": run.cell.config["precision"], "chips": run.cell.chips,
        "vr_s": window.vr_s, "window_peak_bytes": window.window_peak,
    }

    def check():
        from perfbench.reference import train_check

        return train_check.check(program, run.seed, scene_params, scene_dir, follow, run.device,
                                 run.cell.config["limits"], control=run.control)

    return Measured(end_to_end={"train_rays_per_s": counters["rays"] / seconds,
                                "setup_s": window.setup_end - run.t_start},
                    counters=counters, attempted=steps, failed=window.failed, check=check,
                    memory_peak_bytes=memory_peak, trace=trace)
