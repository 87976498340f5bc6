"""The mip-NeRF 360 train step and the chunked image renderer.

Port of the mip path of the reference package's `train/step.py`: Adam with
the log-linear delayed schedule, per-top-level-module value then norm
gradient clipping, the loss assembly, `nan_to_num` on the gradients, the
`grad_norm` stat, and chunked `render_image`. One device, eager PyTorch,
float32 matmuls (TF32 off, see `train/loop.py:set_full_float32`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from outdoor_nerf_depth_torch import models as models_lib
from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.ops import mathx
from outdoor_nerf_depth_torch.train import losses as losses_lib
from outdoor_nerf_depth_torch.train import metrics as metrics_lib
from outdoor_nerf_depth_torch.train.config import Config


def check_supported(config: Config):
    """Raise NotImplementedError for options this slice of the port lacks."""
    unported = []
    if config.model != "mipnerf360":
        unported.append(f"model={config.model}")
    if config.compute_dtype != "float32":
        unported.append(f"compute_dtype={config.compute_dtype}")
    for key, default in (("remat", "none"), ("grad_accum_steps", 1),
                         ("steps_per_dispatch", 1), ("profile_start_step", 0),
                         ("slim_checkpoint", ""), ("weight_decay_mults", {})):
        if getattr(config, key) != default:
            unported.append(f"{key}={getattr(config, key)}")
    for key in ("opacity_loss_mult", "autoexpo_loss_mult", "orientation_loss_mult",
                "orientation_coarse_loss_mult", "predicted_normal_loss_mult",
                "predicted_normal_coarse_loss_mult"):
        if getattr(config, key) > 0:
            unported.append(key)
    if unported:
        raise NotImplementedError(f"not ported yet: {unported}")


def build_model(config: Config, generator: Optional[torch.Generator] = None):
    """The model of `config`, initialized from `generator` (on the CPU)."""
    check_supported(config)
    params = dict(config.model_params or {})
    params.setdefault("compute_dtype", config.compute_dtype)
    params.setdefault("nerf_mlp_params", config.nerf_mlp_params or None)
    params.setdefault("prop_mlp_params", config.prop_mlp_params or None)
    return models_lib.build(config.model, generator=generator, **params)


def make_optimizer(config: Config, model: torch.nn.Module):
    """Adam plus the LR schedule; set the LR to lr_fn(step) before each update.

    Like the reference's optax schedule, the first update uses lr_fn(0).
    """
    lr_fn = functools.partial(
        mathx.lr_schedule,
        lr_init=config.lr_init,
        lr_final=config.lr_final,
        max_steps=config.max_steps,
        warmup_steps=config.lr_delay_steps,
        warmup_mult=config.lr_delay_mult,
    )
    optimizer = torch.optim.Adam(
        model.parameters(), lr=lr_fn(0),
        betas=(config.adam_beta1, config.adam_beta2), eps=config.adam_eps,
    )
    return optimizer, lr_fn


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t**2) for t in tensors))


def clip_gradients(model: torch.nn.Module, config: Config):
    """Per-top-level-module value then norm clipping, in place."""
    if config.grad_max_val <= 0 and config.grad_max_norm <= 0:
        return
    for _, module in model.named_children():
        grads = [p.grad for p in module.parameters()]
        if not grads:
            continue
        if config.grad_max_val > 0:
            for g in grads:
                g.clamp_(-config.grad_max_val, config.grad_max_val)
        if config.grad_max_norm > 0:
            mult = torch.clamp(config.grad_max_norm / (1e-12 + global_norm(grads)), max=1.0)
            for g in grads:
                g.mul_(mult)


def _total_loss(config: Config, batch, renderings, ray_history, rays):
    """The loss terms and stats of one forward pass."""
    stats, loss_terms = {}, {}
    rgb_losses, mses, depth_losses = [], [], []
    use_depth = config.lambda_depth > 0 and batch.depth_sup is not None
    for i, rendering in enumerate(renderings):
        rl, mse = losses_lib.rgb_loss(
            rendering["rgb"], batch.rgb[..., :3], lossmult=rays.lossmult,
            kind=config.data_loss_type, charb_padding=config.charb_padding,
        )
        rgb_losses.append(rl)
        mses.append(mse)
        if use_depth:
            depth_losses.append(
                losses_lib.depth_loss_from_history(
                    ray_history[i], batch.depth_sup,
                    rendering.get("distance_mean", rendering.get("depth")),
                    rays.directions,
                    sigma=config.depth_sigma * config.depth_scale,
                    kind=config.depth_loss_type,
                    reduce=config.depth_loss_reduce,
                    fg_far_mask=config.depth_fg_far_mask,
                )
            )

    rgb_losses = torch.stack(rgb_losses)
    loss_terms["data"] = (
        config.data_coarse_loss_mult * torch.sum(rgb_losses[:-1])
        + config.data_loss_mult * rgb_losses[-1]
    )
    if use_depth:
        dl = torch.stack(depth_losses)
        loss_terms["depth"] = config.lambda_depth * (
            config.data_coarse_loss_mult * torch.sum(dl[:-1]) + config.data_loss_mult * dl[-1]
        )
    if config.interlevel_loss_mult > 0 and len(ray_history) > 1:
        loss_terms["interlevel"] = config.interlevel_loss_mult * losses_lib.interlevel_loss(
            ray_history
        )
    if config.distortion_loss_mult > 0:
        loss_terms["distortion"] = config.distortion_loss_mult * losses_lib.distortion_loss(
            ray_history
        )
    stats["mses"] = torch.stack(mses).detach()
    stats["psnrs"] = metrics_lib.mse_to_psnr(stats["mses"])
    stats["psnr"] = stats["psnrs"][-1]
    return loss_terms, stats


def make_train_step(config: Config, model, optimizer, lr_fn, cameras=None,
                    camtype: str = "perspective"):
    """Returns step(batch, step_index, train_frac, generator=None) -> stats.

    `batch` lives on the model's device. A batch of `Pixels` is cast to rays
    there with `cameras` (tensors on the same device). `step_index` counts
    the updates made so far and sets the learning rate.
    """
    compute_extras = config.lambda_depth > 0 and config.depth_loss_type in (
        "mse", "l1", "urf", "nll"
    )
    params = list(model.parameters())

    def step(batch, step_index: int, train_frac: float, generator=None):
        rays = batch.rays
        if isinstance(rays, rays_lib.Pixels):
            rays = cameras_lib.cast_pixels(rays, cameras, camtype)
        renderings, ray_history = model(
            rays, train_frac=train_frac, compute_extras=compute_extras,
            generator=generator if config.randomized else None,
        )
        loss_terms, stats = _total_loss(config, batch, renderings, ray_history, rays)
        total = sum(loss_terms.values())
        optimizer.zero_grad(set_to_none=False)
        total.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is None:  # unused this step: a zero gradient
                    p.grad = torch.zeros_like(p)
            stats["grad_norm"] = global_norm([p.grad for p in params])
            clip_gradients(model, config)
            for p in params:
                torch.nan_to_num_(p.grad)
        for group in optimizer.param_groups:
            group["lr"] = lr_fn(step_index)
        optimizer.step()
        stats["loss_terms"] = {k: v.detach() for k, v in loss_terms.items()}
        stats["loss"] = total.detach()
        return stats

    return step


@torch.no_grad()
def render_image(model, batch, chunk_size: int = 16384, device=None):
    """Render a full image ([H, W] rays) in chunks; returns numpy [H, W, ...].

    Deterministic (no jitter, train_frac 1) with every extra; the per-ray
    outputs of the finest level.
    """
    device = device or next(model.parameters()).device
    rays = batch.rays
    h, w = rays.origins.shape[:2]
    flat = rays_lib.map_fields(lambda r: r.reshape((h * w,) + r.shape[2:]), rays)
    outs = []
    for start in range(0, h * w, chunk_size):
        chunk = rays_lib.map_fields(lambda r: r[start : start + chunk_size], flat)
        renderings, _ = model(
            rays_lib.to_device(chunk, device), train_frac=1.0, compute_extras=True
        )
        outs.append({k: v.cpu() for k, v in renderings[-1].items()})
    return {
        k: torch.cat([o[k] for o in outs]).reshape((h, w) + outs[0][k].shape[1:]).numpy()
        for k in outs[0]
    }
