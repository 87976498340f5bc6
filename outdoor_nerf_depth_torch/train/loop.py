"""The training loop and the evaluator, on one device.

Port of `train` and `evaluate` from the reference package's `train/loop.py`
for `dataset=synthetic`: prefetched batches -> train step -> JSON log lines
with the reference's keys every `print_every` steps, an optional held-out
view render every `train_render_every` steps, and per-image eval metrics.
An NGP model's occupancy grid (a buffer of the model) is refreshed before
step 0 and then every `occupancy_update_every` steps, sweeping every cell
below `occupancy_warmup_steps`.

Entry points run on CUDA unless the caller passes `device="cpu"`; without
CUDA they raise instead of falling back. Checkpoints are not ported yet: a
run that would resume raises, and nothing is written to `exp_dir`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import datasets as datasets_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.train import metrics as metrics_lib
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import Config


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; raises when CUDA is absent rather than using the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def set_full_float32():
    """Float32 matmuls and convolutions in full precision, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_dataset(config: Config, split: str):
    if config.dataset == "synthetic":
        return datasets_lib.SyntheticDataset(
            split,
            global_batch_size=config.batch_size,
            cast_on_device=config.cast_rays_in_train_step,
        )
    raise NotImplementedError(f"dataset {config.dataset!r} is not ported yet")


def _check_no_resume(config: Config):
    ckpt_dir = os.path.join(config.exp_dir, "checkpoints")
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        raise NotImplementedError(
            f"{ckpt_dir} holds checkpoints, and resuming is not ported yet"
        )


def train(config: Config, device=None, log_fn=print, dataset=None):
    """Train from scratch; returns (model, history of logged stats).

    `dataset` overrides the one `config` names (the same object a caller
    would get from `build_dataset`, at another size).
    """
    device = resolve_device(device)
    set_full_float32()
    _check_no_resume(config)
    max_steps = config.max_steps

    dataset = dataset or build_dataset(config, "train")
    if hasattr(dataset, "scene_scale"):
        config = config.replace(depth_scale=float(dataset.scene_scale))
    init_gen = torch.Generator().manual_seed(config.seed)
    model = step_lib.build_model(config, generator=init_gen).to(device)
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    train_step = step_lib.make_train_step(
        config, model, optimizer, lr_fn,
        cameras=dataset.cameras_on(device), camtype=dataset.camtype,
    )
    # Jitter, background and occupancy-refresh draws, seeded from the config.
    generator = torch.Generator(device=device).manual_seed(config.seed)
    occ_update = step_lib.make_occupancy_update_fn(config, model)
    occ_every, next_occ = config.occupancy_update_every, 0
    batches = datasets_lib.PrefetchIterator(dataset.sample_batch)

    test_dataset = None
    if config.train_render_every > 0:
        test_dataset = build_dataset(config, "test")

    history = []
    t_last, rays_since = time.perf_counter(), 0
    for step in range(max_steps):
        if occ_update is not None and step >= next_occ:
            # The grid starts empty: without this refresh before step 0 the
            # first step would march no sample at all.
            warmup = step < config.occupancy_warmup_steps
            model.occupancy.copy_(occ_update(model.occupancy, generator, warmup))
            next_occ = (step // occ_every + 1) * occ_every
        batch = rays_lib.to_device(next(batches), device, non_blocking=True)
        stats = train_step(batch, step, step / max_steps, generator)
        done = step + 1
        rays_since += config.batch_size
        if (config.print_every > 0 and done % config.print_every == 0) or done == max_steps:
            loss = float(stats["loss"])  # waits for the device
            now = time.perf_counter()
            entry = {
                "step": done,
                "loss": loss,
                "psnr": float(stats["psnr"]),
                "rays_per_sec": rays_since / (now - t_last),
                "rays_per_sec_per_chip": rays_since / (now - t_last),
                "grad_norm": float(stats["grad_norm"]),
                **{f"loss_{k}": float(v) for k, v in stats["loss_terms"].items()},
                **{k: float(stats[k]) for k in ("rm_s", "vr_s") if k in stats},
            }
            history.append(entry)
            log_fn(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                               for k, v in entry.items()}))
            t_last, rays_since = time.perf_counter(), 0
        if test_dataset is not None and done % config.train_render_every == 0:
            idx = (done // config.train_render_every) % test_dataset.n_images
            batch = test_dataset.image_batch(idx)
            rendering = step_lib.render_image(model, batch, config.render_chunk_size, device)
            m = metrics_lib.MetricSuite(compute_ssim=False)(
                rendering["rgb"], batch.rgb.numpy(),
                pred_depth=rendering["distance_mean"],
                gt_depth=None if batch.depth_gt is None else batch.depth_gt.numpy(),
                depth_scale=config.depth_scale,
            )
            log_fn(json.dumps({"step": done, "test_view": idx,
                               **{k: round(v, 4) for k, v in m.items()}}))
    return model, history


def evaluate(config: Config, model, split: str = "test", max_images=None,
             log_fn=print, device=None):
    """Render the split and compute PSNR/SSIM + depth metrics per image.

    Returns (mean metrics, per-image metrics). Renders are not saved.
    """
    device = resolve_device(device)
    set_full_float32()
    dataset = build_dataset(config, split)
    if hasattr(dataset, "scene_scale"):
        config = config.replace(depth_scale=float(dataset.scene_scale))
    suite = metrics_lib.MetricSuite(
        compute_ssim=config.compute_ssim, compute_lpips=config.compute_lpips
    )
    model = model.to(device)
    n = dataset.n_images if max_images is None else min(max_images, dataset.n_images)
    per_image = []
    eval_t0, eval_rays = time.perf_counter(), 0
    for i in range(n):
        batch = dataset.image_batch(i)
        eval_rays += dataset.height * dataset.width
        rendering = step_lib.render_image(model, batch, config.render_chunk_size, device)
        m = suite(
            rendering["rgb"], batch.rgb.numpy(),
            pred_depth=rendering["distance_mean"],
            gt_depth=None if batch.depth_gt is None else batch.depth_gt.numpy(),
            depth_scale=config.depth_scale,
        )
        per_image.append(m)
        log_fn(json.dumps({"image": i, **{k: round(v, 4) for k, v in m.items()}}))
    mean = {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0]}
    mean["test_rays_per_sec"] = eval_rays / (time.perf_counter() - eval_t0)
    log_fn(json.dumps({"split": split, "mean": {k: round(v, 4) for k, v in mean.items()}}))
    return mean, per_image
