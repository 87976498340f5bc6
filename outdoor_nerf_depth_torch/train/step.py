"""The train step, the occupancy-grid refresh and the chunked image renderer.

Port of the reference package's `train/step.py` for the mip-NeRF 360,
Instant-NGP and NeRF++ models: Adam with the log-linear delayed schedule,
per-top-level-module value then norm gradient clipping, the loss assembly
(with NGP's point-sampled distortion, opacity entropy and rm_s/vr_s
marching stats, and NeRF++'s autoexposure normalization and regularizer), `nan_to_num` on the gradients, the `grad_norm` stat, the
NGP occupancy refresh, chunked `render_image`, and the checkpoint identity
(`checkpoint_meta`) and restore (`load_checkpoint`). One device, eager
PyTorch, float32 matmuls (TF32 off, see `train/loop.py:set_full_float32`).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from outdoor_nerf_depth_torch import models as models_lib
from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.models.ngp import HashGridModel, make_density_fn
from outdoor_nerf_depth_torch.ops import mathx
from outdoor_nerf_depth_torch.ops import occupancy as occ_lib
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import losses as losses_lib
from outdoor_nerf_depth_torch.train import metrics as metrics_lib
from outdoor_nerf_depth_torch.train.config import Config


def check_supported(config: Config):
    """Raise NotImplementedError for options this slice of the port lacks."""
    unported = []
    if config.model not in ("mipnerf360", "ngp", "nerfpp"):
        unported.append(f"model={config.model}")
    if config.model == "ngp" and config.ngp_eval_renderer != "train":
        unported.append(f"ngp_eval_renderer={config.ngp_eval_renderer}")
    if config.compute_dtype != "float32":
        unported.append(f"compute_dtype={config.compute_dtype}")
    for key, default in (("remat", "none"), ("grad_accum_steps", 1),
                         ("steps_per_dispatch", 1), ("profile_start_step", 0),
                         ("weight_decay_mults", {})):
        if getattr(config, key) != default:
            unported.append(f"{key}={getattr(config, key)}")
    for key in ("orientation_loss_mult",
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
    if config.model == "mipnerf360":
        params.setdefault("nerf_mlp_params", config.nerf_mlp_params or None)
        params.setdefault("prop_mlp_params", config.prop_mlp_params or None)
    return models_lib.build(config.model, generator=generator, **params)


def checkpoint_meta(config: Config, model) -> dict:
    """Model-identity facts a checkpoint restore must agree on.

    A hash-grid table trained under one hash function loads into a model
    hashing with another (same [L, T, F] shape) and renders garbage. The
    train loop stores this dict as a sidecar, and resume and
    `load_checkpoint` check it.
    """
    meta = {"model": config.model}
    layout = getattr(model, "effective_hash_layout", None)
    if layout is not None:
        # Only the corner layout hashes differently; the others pack one
        # linear hash, so their trained tables are interchangeable.
        meta["hash_function"] = "corner" if layout == "corner" else "linear"
    return meta


def load_checkpoint(config: Config):
    """Restore (model, step) on the CPU from config.exp_dir's latest
    checkpoint, or from `config.slim_checkpoint` when set.

    The model carries its occupancy grid (a buffer). Without a checkpoint
    the model keeps its initialization and the step is 0.
    """
    model = build_model(config, generator=torch.Generator().manual_seed(config.seed))
    expected = checkpoint_meta(config, model)
    if config.slim_checkpoint:
        payload = ckpt_lib.load_slim(config.slim_checkpoint)
        mismatches = ckpt_lib.meta_mismatches(payload.get("meta", {}), expected)
        if mismatches:
            raise ValueError(
                f"slim checkpoint {config.slim_checkpoint!r} was written "
                f"by an incompatible model configuration: {mismatches}"
            )
        names = {name for name, _ in model.named_parameters()}
        if set(payload["params"]) != names:
            raise ValueError(
                f"slim checkpoint {config.slim_checkpoint!r} holds parameters "
                f"{sorted(set(payload['params']) ^ names)} that differ from the model's"
            )
        state = dict(model.state_dict(), **payload["params"])
        if "occupancy" in payload:
            state["occupancy"] = payload["occupancy"]
        model.load_state_dict(state)
        return model, int(payload.get("step", 0))
    ckpt_dir = os.path.join(config.exp_dir, "checkpoints")
    ckpt_lib.check_model_meta(ckpt_dir, expected)
    state, step = ckpt_lib.CheckpointManager(ckpt_dir, keep=config.keep_checkpoints).restore()
    if state is not None:
        model.load_state_dict(state["model"])
    return model, step


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
        rgb_pred = rendering["rgb"]
        if "autoexpo_scale" in rendering:
            # Learned per-image exposure: compare at the canonical exposure.
            rgb_pred = (rgb_pred - rendering["autoexpo_shift"]) / rendering["autoexpo_scale"]
        rl, mse = losses_lib.rgb_loss(
            rgb_pred, batch.rgb[..., :3], lossmult=rays.lossmult,
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
    has_sdist = "sdist" in ray_history[0]
    if config.interlevel_loss_mult > 0 and len(ray_history) > 1 and has_sdist:
        loss_terms["interlevel"] = config.interlevel_loss_mult * losses_lib.interlevel_loss(
            ray_history
        )
    if config.distortion_loss_mult > 0 and (has_sdist or "steps" in ray_history[-1]):
        loss_terms["distortion"] = config.distortion_loss_mult * losses_lib.distortion_loss(
            ray_history
        )
    if config.opacity_loss_mult > 0 and "acc" in renderings[-1]:
        loss_terms["opacity"] = config.opacity_loss_mult * losses_lib.opacity_entropy_loss(
            renderings[-1]["acc"]
        )
    if config.autoexpo_loss_mult > 0 and "autoexpo_scale" in renderings[-1]:
        loss_terms["autoexpo"] = config.autoexpo_loss_mult * losses_lib.autoexposure_reg(
            renderings[-1]["autoexpo_scale"], renderings[-1]["autoexpo_shift"]
        )
    stats["mses"] = torch.stack(mses).detach()
    stats["psnrs"] = metrics_lib.mse_to_psnr(stats["mses"])
    stats["psnr"] = stats["psnrs"][-1]
    # NGP marching efficiency: mean occupied candidates and mean rendered
    # samples per ray this step.
    if "rm_per_ray" in renderings[-1]:
        stats["rm_s"] = renderings[-1]["rm_per_ray"].to(torch.float32).mean()
        stats["vr_s"] = renderings[-1]["vr_per_ray"].to(torch.float32).mean()
    return loss_terms, stats


def make_train_step(config: Config, model, optimizer, lr_fn, cameras=None,
                    camtype: str = "perspective"):
    """Returns step(batch, step_index, train_frac, generator=None) -> stats.

    `batch` lives on the model's device. A batch of `Pixels` is cast to rays
    there with `cameras` (tensors on the same device). `step_index` counts
    the updates made so far and sets the learning rate. An NGP model marches
    through its `occupancy` buffer.
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
            generator=generator if config.randomized else None, **_grid_kwargs(model),
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


def _grid_kwargs(model) -> dict:
    """The occupancy grid an NGP model marches through; nothing for others."""
    return {"occupancy": model.occupancy} if isinstance(model, HashGridModel) else {}


def make_occupancy_update_fn(config: Config, model):
    """The NGP occupancy-grid refresh; None for models without a grid.

    Returns update(grid, generator, warmup) -> new grid. A warmup refresh
    sweeps every cell, a later one `occupancy_cells_per_update` sampled
    cells per cascade. The packed hash tables are built once per refresh,
    not once per chunk of the sweep.
    """
    if not isinstance(model, HashGridModel):
        return None

    @torch.no_grad()
    def update(grid, generator, warmup: bool):
        density_fn = make_density_fn(model, model.prepare_tables())
        return occ_lib.update_grid(
            grid, density_fn, model.scale, decay=config.occupancy_decay,
            n_per_cascade=0 if warmup else config.occupancy_cells_per_update,
            threshold=model.density_threshold, generator=generator,
        )

    return update


@torch.no_grad()
def render_image(model, batch, chunk_size: int = 16384, device=None):
    """Render a full image ([H, W] rays) in chunks; returns numpy [H, W, ...].

    Deterministic (no jitter, train_frac 1) with every extra; the per-ray
    outputs of the finest level. An NGP model marches through its grid.
    """
    device = device or next(model.parameters()).device
    rays = batch.rays
    h, w = rays.origins.shape[:2]
    flat = rays_lib.map_fields(lambda r: r.reshape((h * w,) + r.shape[2:]), rays)
    outs = []
    for start in range(0, h * w, chunk_size):
        chunk = rays_lib.map_fields(lambda r: r[start : start + chunk_size], flat)
        renderings, _ = model(
            rays_lib.to_device(chunk, device), train_frac=1.0, compute_extras=True,
            **_grid_kwargs(model),
        )
        outs.append({k: v.cpu() for k, v in renderings[-1].items()})
    return {
        k: torch.cat([o[k] for o in outs]).reshape((h, w) + outs[0][k].shape[1:]).numpy()
        for k in outs[0]
    }
