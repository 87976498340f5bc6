"""Traffic driver of a trainer: one call of the port's `train/loop.py:train`.

The harness builds the dataset with the port's `build_dataset` (timed as
`scene_load_s`) and makes one `train` call on it, with its native
dataplane and an experiment directory under TMPDIR. The LR schedule spans
the configuration's `max_steps`. The window runs between synchronized
points of the loop: after every `print_every`-th step the run waits for
its card. The first such point at or past `warmup_steps` ends set-up and
opens the window; at each later one the run reads the step's loss (a
loss that is not finite counts as failed) and decides whether `--seconds`
have passed (with `--trace 1`: whether `trace_steps` more steps are
trained, under the profiler). The call is ended from inside the step, so
no checkpoint is written. A stall anywhere between two points counts.

In a process group (`drivers/train_group.py`) every rank runs the same
call and window; rank 0 decides, and one all-reduce a point carries its
decision and each rank's failed count, so every rank stops at the same
step and rank 0 holds the group's count.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time

from perfbench import scene as scene_lib
from perfbench.drivers import common


class WindowClosed(Exception):
    pass


class Window:
    """Wraps the port's `make_train_step` (after `FirstSteps`): opens and
    closes the window at synchronized points, at the same step on every rank."""

    def __init__(self, run, traffic: dict, rank: int, on_card: bool):
        self.run, self.traffic, self.rank, self.on_card = run, traffic, rank, on_card
        self.t0 = self.t1 = self.step0 = self.step1 = self.setup_end = None
        self.setup_peak = self.window_peak = 0
        self.failed = 0
        self.vr_s = []  # the rendered samples a ray of each point's step (NGP)
        self.tracer = None
        self._orig = None

    def install(self):
        from outdoor_nerf_depth_torch.train import step as step_lib

        self._step_lib = step_lib
        self._orig = step_lib.make_train_step
        step_lib.make_train_step = self._make

    def remove(self):
        if self._orig is not None:
            self._step_lib.make_train_step = self._orig

    def _make(self, *args, **kwargs):
        import torch

        step = self._orig(*args, **kwargs)
        every, warmup = self.traffic["print_every"], self.traffic["warmup_steps"]

        def windowed(batch, step_index, train_frac, generator=None):
            stats = step(batch, step_index, train_frac, generator)
            done = step_index + 1
            if done % every:
                return stats
            if self.on_card:
                torch.cuda.synchronize()
            now = time.perf_counter()
            if self.t0 is None:
                if done >= warmup:
                    self._open(now, done)
                return stats
            failed = 0.0 if math.isfinite(float(stats["loss"])) else 1.0
            if "vr_s" in stats:
                self.vr_s.append(float(stats["vr_s"]))
            stop = 0.0
            if self.rank == 0:
                stop = float(done - self.step0 >= self.traffic["trace_steps"] if self.run.trace
                             else now - self.t0 >= self.run.seconds)
            stop, failed = self._reduce(stop, failed, batch.rgb.device)
            self.failed += int(failed)
            if stop > 0:
                self.t1, self.step1 = now, done
                if self.tracer is not None:
                    self.tracer.stop()
                if self.on_card:
                    self.window_peak = torch.cuda.max_memory_allocated()
                raise WindowClosed
            return stats

        return windowed

    @staticmethod
    def _reduce(stop: float, failed: float, device):
        """Rank 0's decision and the ranks' failed count, summed over a process group."""
        import torch
        from torch import distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return stop, failed
        flags = torch.tensor([stop, failed], device=device)
        dist.all_reduce(flags)
        return float(flags[0]), float(flags[1])

    def _open(self, now: float, done: int):
        import torch

        self.setup_end = now
        if self.on_card:
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if self.run.trace:
            from perfbench.trace import Tracer

            self.tracer = Tracer(self.run.device)
            self.tracer.start()
        self.t0, self.step0 = time.perf_counter(), done


def train_call(run, rank: int, device, scene_dir: str, exp_dir: str):
    """The one `train` call of a rank, with the first steps followed and the
    window measured: (window, first steps, program config, scene_load_s)."""
    from outdoor_nerf_depth_torch.train import loop

    traffic = common.traffic(run)
    if traffic["follow_steps"] > traffic["warmup_steps"]:
        raise ValueError("the followed steps must end before the window opens")
    config = common.program_config(run, scene_dir, exp_dir, print_every=traffic["print_every"])
    t0 = time.perf_counter()
    dataset = loop.build_dataset(config, "train")
    scene_load_s = time.perf_counter() - t0
    follow = common.FirstSteps(traffic["follow_steps"])
    window = Window(run, traffic, rank, run.device == "cuda")
    follow.install()
    window.install()
    try:
        loop.train(config, device=device, log_fn=lambda line: None, dataset=dataset)
        raise RuntimeError("the train call ended before the window closed")
    except WindowClosed:
        pass
    finally:
        window.remove()
        follow.remove()
    return window, follow, config, scene_load_s


def run(run):
    params = common.scene_params(run)
    scene_dir = scene_lib.ensure_scene(run.cache_root, params)
    exp_dir = tempfile.mkdtemp(prefix="perfbench-exp-")
    try:
        window, follow, config, scene_load_s = train_call(run, 0, run.device, scene_dir, exp_dir)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    return common.train_measured(
        run, window, follow, config, params, scene_dir, scene_load_s=scene_load_s,
        memory_peak=max(window.setup_peak, window.window_peak),
        trace=window.tracer.summary() if window.tracer is not None else None)
