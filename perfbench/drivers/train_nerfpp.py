"""Traffic driver of a NeRF++ trainer: the `train` driver's one call of the
port's `train/loop.py:train` on the scene in the NeRF++ layout.

The set-up, the window and the measured numbers are the `train` driver's
(`drivers/train.py:train_call`, `common.train_measured`); the scene is
written by `perfbench/scene_nerfpp.py`, and the output check is
`reference/nerfpp_check.py`. The port's NeRF++ reader gives each camera
its own intrinsics, so the loop samples pixels and the step casts them:
the followed batches are kept as pixels, which the check casts from the
layout itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import tempfile

from perfbench import scene_nerfpp
from perfbench.drivers import common
from perfbench.drivers import train as train_driver

PIXEL_FIELDS = ("pix_x", "pix_y", "cam_idx", "lossmult", "near", "far")


def pixel_batch_to_cpu(batch) -> dict:
    """The fields of a train batch of uncast pixels as CPU tensors."""
    out = {k: common.cpu_copy(getattr(batch.rays, k)) for k in PIXEL_FIELDS}
    out.update(rgb=common.cpu_copy(batch.rgb), depth_gt=common.cpu_copy(batch.depth_gt),
               depth_sup=common.cpu_copy(batch.depth_sup))
    return out


@contextlib.contextmanager
def pixel_batches():
    """`common.FirstSteps` keeps each followed batch as its pixels."""
    orig = common.batch_to_cpu
    common.batch_to_cpu = pixel_batch_to_cpu
    try:
        yield
    finally:
        common.batch_to_cpu = orig


def run(run):
    params = common.scene_params(run)
    scene_dir = scene_nerfpp.ensure_scene(run.cache_root, params)
    exp_dir = tempfile.mkdtemp(prefix="perfbench-exp-")
    try:
        with pixel_batches():
            window, follow, config, scene_load_s = train_driver.train_call(
                run, 0, run.device, scene_dir, exp_dir)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    measured = common.train_measured(
        run, window, follow, config, params, scene_dir, scene_load_s=scene_load_s,
        memory_peak=max(window.setup_peak, window.window_peak),
        trace=window.tracer.summary() if window.tracer is not None else None)
    program = dataclasses.asdict(config)

    def check():
        from perfbench.reference import nerfpp_check

        return nerfpp_check.check(program, run.seed, scene_dir, follow, run.device,
                                  run.cell.config["limits"], control=run.control)

    measured.check = check
    return measured
