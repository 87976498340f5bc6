"""The training loop and the evaluator, on one device or over a process group.

Port of `train` and `evaluate` from the reference package's `train/loop.py`
for every dataset the reference's `build_dataset` reads (`synthetic`,
`spheres`, `driving`, `nerfpp`, `tnt`, `blender`, `tnt_fvs`, `dtu`, `nsvf`
and `rtmv`): prefetched
batches (from the C++ dataplane, `data/native_batcher.py`, under the
reference loop's rule: `use_native_batcher` and one shared [3, 3] intrinsics
matrix; else from `dataset.sample_batch`) -> train step -> JSON log lines with the reference's keys every
`print_every` steps, an optional held-out view render every
`train_render_every` steps, checkpoints, and per-image eval metrics with
the renders saved. The log lines' numbers also go to a `MetricWriter` in
`exp_dir/logs` (`train/...` and `train_render/...` scalars, and the
held-out view's panel image when TensorBoard is present). An NGP model's
occupancy grid (a buffer of the model) is refreshed before step 0 and then
every `occupancy_update_every` steps, sweeping every cell below
`occupancy_warmup_steps`.

With `steps_per_dispatch` K > 1 the loop runs K steps per iteration (the
reference fuses them into one compiled dispatch; eager PyTorch has none to
fuse, so they run one after another), each on its own batch and its own
`train_frac`. The grid refresh falls due before an iteration; printing,
test renders and checkpoints fire when an iteration crosses their cadence,
and at `max_steps`, and a log line carries the iteration's last step.
`profile_start_step` > 0 records a `torch.profiler` trace of the steps
from there for `profile_num_steps` steps (whole iterations) into
`exp_dir/trace`.

`train` writes `exp_dir/config.json` and the model-identity sidecar, saves a
checkpoint every `checkpoint_every` steps and at `max_steps` (the one
labelled N holds N trained steps), resumes from the latest checkpoint, and
returns the restored model without training when that checkpoint is at or
past `max_steps`.

Entry points run on CUDA unless the caller passes `device="cpu"`; without
CUDA they raise instead of falling back.

In a process group (`parallel/`, joined by `python -m
outdoor_nerf_depth_torch` under torchrun) every rank runs `train` and
`evaluate`: each samples its share of the global batch, the parameters
start as rank 0's, the step is the global batch's (`train/step.py`), and
the test renders are split over the ranks. Rank 0 alone writes
`config.json`, the sidecar, the log lines, the `MetricWriter`'s scalars,
the renders, the profiler trace and the checkpoints; after a save the
ranks meet at a barrier, and on resume every rank loads the checkpoint
(the reference lets Orbax coordinate its multi-host saves). The log's
`rays_per_sec_per_chip` is the global rate over the world size.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from outdoor_nerf_depth_torch import parallel
from outdoor_nerf_depth_torch.data import datasets as datasets_lib
from outdoor_nerf_depth_torch.data import native_batcher
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import metrics as metrics_lib
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import Config, save_config
from outdoor_nerf_depth_torch.utils import image as image_lib
from outdoor_nerf_depth_torch.utils import vis as vis_lib
from outdoor_nerf_depth_torch.utils.logging import MetricWriter


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA (in a process group, the rank's current card);
    raises when CUDA is absent rather than using the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        device = torch.device("cuda", torch.cuda.current_device()) if parallel.active() else "cuda"
    return torch.device(device)


class _NoWriter:
    """The metric writer of ranks other than 0: writes nothing."""

    def scalars(self, *args, **kwargs):
        pass

    def image(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _quiet(line):
    del line


def set_full_float32():
    """Float32 matmuls and convolutions in full precision, never TF32; bf16
    matmuls accumulate in float32 throughout, as the reference's do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def crossed(before: int, after: int, every: int) -> bool:
    """Whether going from `before` to `after` trained steps passes a multiple of `every`."""
    return every > 0 and after // every > before // every


class _ProfileWindow:
    """A torch.profiler trace of the steps [start, start + num_steps), whole
    iterations of K steps, written to `trace_dir` as a Chrome trace."""

    def __init__(self, start: int, num_steps: int, trace_dir: str, device: torch.device):
        self.start_step, self.stop_at, self.trace_dir = start, start + num_steps, trace_dir
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof, self.first = None, None

    def before(self, step: int, k: int):
        """Start when this iteration's K steps reach the window."""
        if self.start_step and self.first is None and step + k > self.start_step:
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
            self.first = step

    def after(self, step: int, force: bool = False):
        """Stop once `step` steps are trained past the window (or when forced)."""
        if self.prof is not None and (force or step >= self.stop_at):
            self.prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            self.prof.export_chrome_trace(
                os.path.join(self.trace_dir, f"steps_{self.first}_{step}.json"))
            self.prof = None


def build_dataset(config: Config, split: str):
    if config.dataset == "synthetic":
        return datasets_lib.SyntheticDataset(
            split,
            global_batch_size=config.batch_size,
            cast_on_device=config.cast_rays_in_train_step,
        )
    if config.dataset == "spheres":
        return datasets_lib.SphereSceneDataset(
            split,
            global_batch_size=config.batch_size,
            cast_on_device=config.cast_rays_in_train_step,
            sample_every=config.sample_every if split == "train" else 1,
            depth_sup_type=config.depth_sup_type,
        )
    if config.dataset == "driving":
        return datasets_lib.DrivingSceneDataset(
            config.scene_dir,
            split,
            global_batch_size=config.batch_size,
            near=config.near,
            far=config.far,
            factor=config.factor,
            depth_sup_type=config.depth_sup_type,
            sample_every=config.sample_every if split == "train" else 1,
            depth_crop_range=config.depth_crop_range,
            depth_keep_ratio=config.depth_keep_ratio,
            auto_adjust_near_far=config.auto_adjust_near_far,
            load_depth=config.depth_sup_type != "rgbonly",
            cast_on_device=config.cast_rays_in_train_step,
        )
    if config.dataset in ("nerfpp", "tnt"):
        cls = (datasets_lib.TanksAndTemplesDataset if config.dataset == "tnt"
               else datasets_lib.NerfppSceneDataset)
        return cls(
            config.scene_dir,
            split,
            global_batch_size=config.batch_size,
            skip=config.sample_every if split == "train" else 1,
            depth_sup_type=config.depth_sup_type,
            cast_on_device=config.cast_rays_in_train_step,
        )
    if config.dataset == "tnt_fvs":
        return datasets_lib.TanksAndTemplesFVSDataset(
            config.scene_dir,
            split,
            global_batch_size=config.batch_size,
            factor=config.factor,
            cast_on_device=config.cast_rays_in_train_step,
        )
    readers = {"blender": datasets_lib.BlenderDataset, "dtu": datasets_lib.DTUDataset,
               "nsvf": datasets_lib.NSVFDataset, "rtmv": datasets_lib.RTMVDataset}
    if config.dataset in readers:
        return readers[config.dataset](
            config.scene_dir,
            split,
            global_batch_size=config.batch_size,
            near=config.near,
            far=config.far,
            cast_on_device=config.cast_rays_in_train_step,
        )
    raise ValueError(f"unknown dataset {config.dataset!r}")


def train(config: Config, device=None, log_fn=print, dataset=None, max_steps=None):
    """Train, resuming from exp_dir's latest checkpoint; returns (model,
    history of logged stats).

    `dataset` overrides the one `config` names (the same object a caller
    would get from `build_dataset`, at another size). `max_steps` stops the
    run early: the LR schedule still spans `config.max_steps`, as in a run
    cut short.
    """
    device = resolve_device(device)
    set_full_float32()
    step_lib.check_supported(config)
    max_steps = max_steps or config.max_steps
    lead = parallel.rank() == 0
    log_fn = log_fn if lead else _quiet
    os.makedirs(config.exp_dir, exist_ok=True)
    if lead:
        save_config(config, os.path.join(config.exp_dir, "config.json"))

    # Idempotent-run guard: a checkpoint at or past max_steps means this run
    # finished; hand back the restored model without loading the data.
    ckpt_dir = os.path.join(config.exp_dir, "checkpoints")
    latest = ckpt_lib.latest_step(ckpt_dir)
    if latest is not None and latest >= max_steps:
        log_fn(json.dumps({"step": latest, "already_complete": True}))
        model, _ = step_lib.load_checkpoint(config.replace(slim_checkpoint=""))
        return model.to(device), []

    dataset = dataset or build_dataset(config, "train")
    if hasattr(dataset, "scene_scale"):
        config = config.replace(depth_scale=float(dataset.scene_scale))
    init_gen = torch.Generator().manual_seed(config.seed)
    model = parallel.put_replicated(step_lib.build_model(config, generator=init_gen).to(device))
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    train_step = step_lib.make_train_step(
        config, model, optimizer, lr_fn,
        cameras=dataset.cameras_on(device), camtype=dataset.camtype,
    )
    # Jitter, background and occupancy-refresh draws, seeded from the config.
    generator = torch.Generator(device=device).manual_seed(config.seed)

    # The checkpoint holds the model (with the NGP occupancy grid), the
    # optimizer and the generator, so a resumed run continues the same run.
    meta = step_lib.checkpoint_meta(config, model)
    ckpt_lib.check_model_meta(ckpt_dir, meta)
    parallel.barrier()  # every rank has read the sidecar before rank 0 rewrites it
    ckpt = None
    if lead:
        ckpt_lib.write_model_meta(ckpt_dir, meta)
        ckpt = ckpt_lib.CheckpointManager(ckpt_dir, keep=config.keep_checkpoints)
    parallel.barrier()
    state, start_step = ckpt_lib.restore(ckpt_dir)
    if state is not None:
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        generator.set_state(state["generator"])
        log_fn(json.dumps({"restored_step": start_step}))

    occ_update = step_lib.make_occupancy_update_fn(config, model)
    occ_every = config.occupancy_update_every
    # A resumed run refreshes at its first step when a refresh fell due
    # since the last multiple of the cadence.
    next_occ = (start_step // occ_every) * occ_every if occ_update is not None else None
    sample_fn = dataset.sample_batch
    if native_batcher.applies(config, dataset):
        # The reference loop's batch source. A failed build raises here (the
        # reference logs it and falls back to `dataset.sample_batch`).
        sample_fn = native_batcher.NativeRayBatcher(dataset, seed=config.seed).sample_batch
    batches = datasets_lib.PrefetchIterator(sample_fn)
    writer = MetricWriter(os.path.join(config.exp_dir, "logs")) if lead else _NoWriter()

    test_dataset = None
    if config.train_render_every > 0:
        test_dataset = build_dataset(config, "test")

    n_fuse = max(1, config.steps_per_dispatch)
    profile = _ProfileWindow(config.profile_start_step if lead else 0, config.profile_num_steps,
                             os.path.join(config.exp_dir, "trace"), device)
    n_ranks = parallel.world()
    history = []
    t_last, rays_since = time.perf_counter(), 0
    step = start_step
    while step < max_steps:
        fused = min(n_fuse, max_steps - step)
        profile.before(step, n_fuse)
        if occ_update is not None and step >= next_occ:
            # The grid starts empty: without this refresh before step 0 the
            # first step would march no sample at all.
            warmup = step < config.occupancy_warmup_steps
            model.occupancy.copy_(occ_update(model.occupancy, generator, warmup))
            next_occ = (step // occ_every + 1) * occ_every
        for i in range(fused):
            batch = rays_lib.to_device(next(batches), device, non_blocking=True)
            stats = train_step(batch, step + i, (step + i) / max_steps, generator)
        prev, step = step, step + fused
        rays_since += config.batch_size * fused
        profile.after(step)
        if crossed(prev, step, config.print_every) or step == max_steps:
            loss = float(stats["loss"])  # waits for the device
            now = time.perf_counter()
            entry = {
                "step": step,
                "loss": loss,
                "psnr": float(stats["psnr"]),
                "rays_per_sec": rays_since / (now - t_last),
                "rays_per_sec_per_chip": rays_since / (now - t_last) / n_ranks,
                "grad_norm": float(stats["grad_norm"]),
                **{f"loss_{k}": float(v) for k, v in stats["loss_terms"].items()},
                **{k: float(stats[k]) for k in ("rm_s", "vr_s") if k in stats},
            }
            history.append(entry)
            log_fn(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                               for k, v in entry.items()}))
            writer.scalars(step, entry, prefix="train")
            t_last, rays_since = time.perf_counter(), 0
        if test_dataset is not None and crossed(prev, step, config.train_render_every):
            idx = (step // config.train_render_every) % test_dataset.n_images
            batch = test_dataset.image_batch(idx)
            rendering = step_lib.render_image(model, batch, config.render_chunk_size, device,
                                              config.ngp_eval_renderer)
            m = metrics_lib.MetricSuite(compute_ssim=False)(
                rendering["rgb"], batch.rgb.numpy(),
                pred_depth=rendering["distance_mean"],
                gt_depth=None if batch.depth_gt is None else batch.depth_gt.numpy(),
                depth_scale=config.depth_scale,
            )
            writer.scalars(step, m, prefix="train_render")
            panel = vis_lib.side_by_side(
                rendering["rgb"], batch.rgb.numpy(),
                vis_lib.visualize_depth(rendering["distance_mean"] / config.depth_scale))
            writer.image(step, "train_render/view", panel)
            log_fn(json.dumps({"step": step, "test_view": idx,
                               **{k: round(v, 4) for k, v in m.items()}}))
        # The checkpoint labelled N holds N trained steps.
        if crossed(prev, step, config.checkpoint_every) or step == max_steps:
            if lead:
                ckpt.save(step, {"model": model.state_dict(),
                                 "optimizer": optimizer.state_dict(),
                                 "step": step, "generator": generator.get_state()})
            parallel.barrier()
    profile.after(step, force=True)  # a window that ran past max_steps
    writer.close()
    return model, history


def evaluate(config: Config, model, split: str = "test", max_images=None,
             log_fn=print, device=None, save_renders: bool = True):
    """Render the split and compute PSNR/SSIM(/LPIPS) + depth metrics per image.

    With `save_renders`, writes into `exp_dir/renders/` per image
    `color_###.png` (8-bit, the reference's truncating codes),
    `depth_###.png` (uint16, metres * 256) and `summary_###.png` (render,
    ground truth, the depth visualization and, where the view has ground
    truth depth, the signed depth error). Returns (mean metrics, per-image
    metrics). In a process group every rank renders its share of each view
    and returns the metrics; rank 0 alone logs and writes the renders.
    """
    device = resolve_device(device)
    set_full_float32()
    lead = parallel.rank() == 0
    log_fn = log_fn if lead else _quiet
    save_renders = save_renders and lead
    dataset = build_dataset(config, split)
    if hasattr(dataset, "scene_scale"):
        config = config.replace(depth_scale=float(dataset.scene_scale))
    suite = metrics_lib.MetricSuite(
        compute_ssim=config.compute_ssim, compute_lpips=config.compute_lpips, device=device
    )
    render_dir = os.path.join(config.exp_dir, "renders")
    if save_renders:
        os.makedirs(render_dir, exist_ok=True)
    model = model.to(device)
    n = dataset.n_images if max_images is None else min(max_images, dataset.n_images)
    per_image = []
    eval_t0, eval_rays = time.perf_counter(), 0
    for i in range(n):
        batch = dataset.image_batch(i)
        eval_rays += dataset.height * dataset.width
        rendering = step_lib.render_image(model, batch, config.render_chunk_size, device,
                                          config.ngp_eval_renderer)
        gt_rgb = batch.rgb.numpy()
        gt_depth = None if batch.depth_gt is None else batch.depth_gt.numpy()
        m = suite(
            rendering["rgb"], gt_rgb,
            pred_depth=rendering["distance_mean"],
            gt_depth=gt_depth,
            depth_scale=config.depth_scale,
        )
        per_image.append(m)
        log_fn(json.dumps({"image": i, **{k: round(v, 4) for k, v in m.items()}}))
        if save_renders:
            rgb = rendering["rgb"]
            depth = rendering["distance_mean"] / config.depth_scale
            image_lib.save_img_u8(rgb, os.path.join(render_dir, f"color_{i:03d}.png"))
            image_lib.save_depth_u16(depth, os.path.join(render_dir, f"depth_{i:03d}.png"))
            panels = [rgb, gt_rgb, vis_lib.visualize_depth(depth)]
            if gt_depth is not None:
                panels.append(vis_lib.depth_error_map(depth, gt_depth / config.depth_scale))
            image_lib.save_img_u8(vis_lib.side_by_side(*panels),
                                  os.path.join(render_dir, f"summary_{i:03d}.png"))
    mean = {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0]}
    mean["test_rays_per_sec"] = eval_rays / (time.perf_counter() - eval_t0)
    log_fn(json.dumps({"split": split, "mean": {k: round(v, 4) for k, v in mean.items()}}))
    return mean, per_image
