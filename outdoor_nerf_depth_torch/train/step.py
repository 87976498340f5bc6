"""The train step, the occupancy-grid refresh and the chunked image renderer.

Port of the reference package's `train/step.py` for the mip-NeRF 360,
Instant-NGP and NeRF++ models: Adam with the log-linear delayed schedule,
per-top-level-module value then norm gradient clipping, the loss assembly
(with the Ref-NeRF orientation and predicted-normal terms, NGP's
point-sampled distortion, opacity entropy and rm_s/vr_s marching stats,
NeRF++'s autoexposure normalization and regularizer, and the
`weight_decay_mults` term), `nan_to_num` on the gradients, the
`grad_norm` stat, the forward under `remat` (none, dots or full),
gradient accumulation over `grad_accum_steps` chunks of the batch, the NGP
occupancy refresh, chunked `render_image` (NGP through the iterative
renderer when `ngp_eval_renderer="iterative"`; mip-NeRF 360 without its
GLO and exposure embeddings, as the reference evaluates), and the checkpoint
identity (`checkpoint_meta`) and restore (`load_checkpoint`). Eager
PyTorch on one device, or on each rank of a process group (`parallel/`:
the train step on the global batch with one flat gradient all-reduce, the
replicated occupancy grid, the render split over the ranks); the model
computes in its `compute_dtype`, and float32 matmuls run in full float32
(TF32 off, see `train/loop.py:set_full_float32`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Optional

import torch
from torch.utils import checkpoint as checkpoint_lib

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch import models as models_lib
from outdoor_nerf_depth_torch import parallel
from outdoor_nerf_depth_torch.data import cameras as cameras_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.models import mlps
from outdoor_nerf_depth_torch.models.mipnerf360 import ProposalModel
from outdoor_nerf_depth_torch.models.ngp import HashGridModel, make_density_fn
from outdoor_nerf_depth_torch.ops import mathx
from outdoor_nerf_depth_torch.ops import occupancy as occ_lib
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import losses as losses_lib
from outdoor_nerf_depth_torch.train import metrics as metrics_lib
from outdoor_nerf_depth_torch.train.config import Config
from outdoor_nerf_depth_torch.utils import tracing


REMAT_MODES = ("none", "dots", "full")
# The matmuls whose outputs remat="dots" keeps, like the reference's
# `checkpoint_dots` policy: every other op of the forward is recomputed.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def check_supported(config: Config):
    """Raise NotImplementedError for a model the port lacks, and ValueError
    for values no version of it takes."""
    if config.remat not in REMAT_MODES + (None,):
        raise ValueError(f"remat={config.remat!r}: expected one of {REMAT_MODES}")
    if config.ngp_eval_renderer not in ("train", "iterative"):
        raise ValueError(f"ngp_eval_renderer={config.ngp_eval_renderer!r}")
    if config.model not in ("mipnerf360", "ngp", "nerfpp"):
        raise NotImplementedError(f"not ported yet: model={config.model}")


def build_model(config: Config, generator: Optional[torch.Generator] = None):
    """The model of `config`, initialized from `generator` (on the CPU).

    It computes in the config's `compute_dtype` unless `model_params` names
    another; its parameters are float32 either way.
    """
    check_supported(config)
    params = dict(config.model_params or {})
    params["compute_dtype"] = mathx.as_dtype(params.get("compute_dtype", config.compute_dtype))
    if config.model == "mipnerf360":
        params.setdefault("nerf_mlp_params", config.nerf_mlp_params or None)
        params.setdefault("prop_mlp_params", config.prop_mlp_params or None)
        params.setdefault("vis_num_rays", config.vis_num_rays)
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
    """Per-top-level-module value then norm clipping, in place: each child
    of the model is a group, as each top-level Flax module is in the
    reference (NGP's `field`, and `pose_dR` and `pose_dT` under
    `optimize_ext`; mip-NeRF 360's `glo` and `exposure_scaling`)."""
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


def _total_loss(config: Config, batch, renderings, ray_history, rays, share=None):
    """The loss terms and stats of one forward pass.

    With a `share` (data parallelism) each term and stat is this rank's
    share of the whole batch's value, so the ranks' shares sum to it: the
    photometric terms divide by the batch's lossmult sum, mse's and l1's
    "mean_valid" by its count of valid depths, and every mean over rays
    (the other terms, nll's sum over all rays among them, and the
    weight-decay term, which counts once a batch) is scaled by this rank's
    share of the batch's rays."""
    stats, loss_terms = {}, {}
    rgb_losses, mses, depth_losses = [], [], []
    use_depth = config.lambda_depth > 0 and batch.depth_sup is not None
    per_ray = (lambda x: x) if share is None else (lambda x: x * share.rays)
    depth_share = (lambda x: x) if share is None or (
        config.depth_loss_type in ("mse", "l1") and config.depth_loss_reduce == "mean_valid"
    ) else per_ray
    for i, rendering in enumerate(renderings):
        rgb_pred = rendering["rgb"]
        if "autoexpo_scale" in rendering:
            # Learned per-image exposure: compare at the canonical exposure.
            rgb_pred = (rgb_pred - rendering["autoexpo_shift"]) / rendering["autoexpo_scale"]
        rl, mse = losses_lib.rgb_loss(
            rgb_pred, batch.rgb[..., :3], lossmult=rays.lossmult,
            kind=config.data_loss_type, charb_padding=config.charb_padding,
            denom=None if share is None else share.lossmult,
        )
        rgb_losses.append(rl)
        mses.append(mse)
        if use_depth:
            depth_losses.append(depth_share(
                losses_lib.depth_loss_from_history(
                    ray_history[i], batch.depth_sup,
                    rendering.get("distance_mean", rendering.get("depth")),
                    rays.directions,
                    sigma=config.depth_sigma * config.depth_scale,
                    kind=config.depth_loss_type,
                    reduce=config.depth_loss_reduce,
                    fg_far_mask=config.depth_fg_far_mask,
                    n_valid=None if share is None else share.depth_valid,
                )
            ))

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
        loss_terms["interlevel"] = config.interlevel_loss_mult * per_ray(
            losses_lib.interlevel_loss(ray_history))
    if config.distortion_loss_mult > 0 and (has_sdist or "steps" in ray_history[-1]):
        loss_terms["distortion"] = config.distortion_loss_mult * per_ray(
            losses_lib.distortion_loss(ray_history))
    if config.orientation_loss_mult > 0 or config.orientation_coarse_loss_mult > 0:
        loss_terms["orientation"] = per_ray(losses_lib.orientation_loss(
            ray_history, rays.viewdirs, config.orientation_coarse_loss_mult,
            config.orientation_loss_mult, target=config.orientation_loss_target,
        ))
    if config.predicted_normal_loss_mult > 0 or config.predicted_normal_coarse_loss_mult > 0:
        loss_terms["predicted_normals"] = per_ray(losses_lib.predicted_normal_loss(
            ray_history, config.predicted_normal_coarse_loss_mult,
            config.predicted_normal_loss_mult,
        ))
    if config.opacity_loss_mult > 0 and "acc" in renderings[-1]:
        loss_terms["opacity"] = config.opacity_loss_mult * per_ray(
            losses_lib.opacity_entropy_loss(renderings[-1]["acc"]))
    if config.autoexpo_loss_mult > 0 and "autoexpo_scale" in renderings[-1]:
        loss_terms["autoexpo"] = config.autoexpo_loss_mult * per_ray(losses_lib.autoexposure_reg(
            renderings[-1]["autoexpo_scale"], renderings[-1]["autoexpo_shift"]
        ))
    stats["mses"] = torch.stack(mses).detach()
    stats["psnrs"] = metrics_lib.mse_to_psnr(stats["mses"])
    stats["psnr"] = stats["psnrs"][-1]
    # NGP marching efficiency: mean occupied candidates and mean rendered
    # samples per ray this step.
    if "rm_per_ray" in renderings[-1]:
        stats["rm_s"] = per_ray(renderings[-1]["rm_per_ray"].to(torch.float32).mean())
        stats["vr_s"] = per_ray(renderings[-1]["vr_per_ray"].to(torch.float32).mean())
    return loss_terms, stats


def _remat_on(config: Config) -> bool:
    return config.remat not in ("none", None)  # the command line reads none as None


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _DOT_OPS:
        return checkpoint_lib.CheckpointPolicy.MUST_SAVE
    return checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return checkpoint_lib.create_selective_checkpoint_contexts(_dots_policy)


def make_forward(config: Config, model, compute_extras: bool):
    """forward(rays, train_frac, generator) -> (renderings, ray_history).

    Under `remat` "dots" or "full" the model's forward (not the loss) is a
    non-reentrant checkpoint: "full" keeps nothing inside it, "dots" keeps
    the matmul outputs; the backward recomputes the rest. The recompute
    starts from the generator state the forward started from, so it draws
    the same jitter; the caller puts the generator back where the forward
    left it once the backward is done (the recompute may stop early). It
    also runs under the forward's row shard (`parallel.mesh.row_shard`):
    on a card, autograd runs the backward, and so the recompute, on its own
    thread, which does not see the caller's contextvars, so without it the
    recompute would draw one rank's rows where the forward drew its rows of
    the global batch, and plan NGP's samples without the other ranks. The
    Ref-NeRF density-normal passes keep their tensors and are replayed, not
    recomputed (`mlps.reuse_density_passes`).
    """

    # Training uses the mip-NeRF 360 model's GLO and exposure embeddings.
    train_kwargs = {"zero_glo": False} if isinstance(model, ProposalModel) else {}

    def run(rays, train_frac, generator):
        return model(rays, train_frac=train_frac, compute_extras=compute_extras,
                     generator=generator, **_grid_kwargs(model), **train_kwargs)

    if not _remat_on(config):
        return run
    context_fn = _dots_contexts if config.remat == "dots" else checkpoint_lib.noop_context_fn

    def forward(rays, train_frac, generator):
        start = None if generator is None else generator.get_state()
        shard = parallel.mesh.current_row_shard()
        calls = []
        density_passes = mlps.DensityPassCache()

        def region(region_rays):
            if calls and start is not None:  # the recompute, inside the backward
                generator.set_state(start)
            replay = bool(calls)
            calls.append(None)
            with mlps.reuse_density_passes(model, density_passes, replay), \
                    parallel.mesh.in_row_shard(shard):
                return run(region_rays, train_frac, generator)

        return checkpoint_lib.checkpoint(region, rays, use_reentrant=False,
                                         context_fn=context_fn)

    return forward


def _decayed_params(config: Config, model):
    """(mult, parameters) of each top-level module `weight_decay_mults` names
    (by its name in the reference's parameter tree); absent names add nothing."""
    out = []
    for name, mult in (config.weight_decay_mults or {}).items():
        module = convert.flax_submodule(model, name)
        if module is not None:
            out.append((float(mult), list(module.parameters())))
    return out


def _chunks(obj, n: int):
    """`obj` (a batch or rays) cut into n equal chunks along the ray axis, in order."""
    size = rays_lib.leaves(obj)[0].shape[0]
    if size % n:
        raise ValueError(f"grad_accum_steps={n} does not divide a batch of {size} rays")
    return [rays_lib.map_fields(lambda x: x[i * (size // n):(i + 1) * (size // n)], obj)
            for i in range(n)]


def _mean_stats(stats):
    """The mean over chunks of every stat (nested dicts of tensors)."""
    first = stats[0]
    if isinstance(first, dict):
        return {k: _mean_stats([s[k] for s in stats]) for k in first}
    return torch.mean(torch.stack(stats), dim=0)


@dataclasses.dataclass(frozen=True)
class Share:
    """What a rank needs to take its share of a chunk's loss: its share of
    the chunk's rays, and the chunk's lossmult sum and count of valid depths
    over every rank that holds rows of it."""

    rays: float
    lossmult: torch.Tensor
    depth_valid: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChunkLayout:
    """The reference's accumulation chunks of the global batch as a rank
    holds them: chunk c is global rows [c B / n, (c + 1) B / n), and rank r
    holds rows [r B / W, (r + 1) B / W). This rank cuts its rows into
    `n_local` chunks, the global chunks `chunk_ids`, each shared with
    `count` ranks among which its rows are block `index`."""

    n_local: int
    chunk_ids: tuple
    index: int
    count: int


def chunk_layout(n_accum: int, mesh_: parallel.Mesh) -> ChunkLayout:
    """Where n is a multiple of W each rank holds n / W whole chunks; where
    W is a multiple of n each chunk spans W / n ranks. Other pairs would
    split a rank's rows unevenly between chunks: ValueError."""
    n, w, r = n_accum, mesh_.size, mesh_.rank
    if n % w == 0:
        k = n // w
        return ChunkLayout(k, tuple(range(r * k, (r + 1) * k)), 0, 1)
    if w % n == 0:
        k = w // n
        return ChunkLayout(1, (r // k,), r % k, k)
    raise ValueError(f"grad_accum_steps={n} over {w} ranks: the reference's chunks of the "
                     "global batch would split a rank's rows unevenly (one must divide the other)")


def _denominators(batch, rays) -> torch.Tensor:
    """[lossmult sum over the rgb channels, count of valid depths] of a chunk, float64."""
    target = batch.rgb[..., :3]
    lossmult = (torch.ones_like(target) if rays.lossmult is None
                else rays.lossmult.expand(target.shape))
    valid = (torch.zeros((), device=target.device) if batch.depth_sup is None
             else (batch.depth_sup > 0).sum())
    return torch.stack([lossmult.sum().double(), valid.double()])


def _stat_vector(stats) -> torch.Tensor:
    """The stats that sum over ranks, flat: loss, each loss term, the mses
    and the marching counters (the psnrs are taken after the sum)."""
    parts = [stats["loss"].reshape(1)] + [v.reshape(1) for v in stats["loss_terms"].values()]
    parts += [stats["mses"].reshape(-1)] + [stats[k].reshape(1) for k in ("rm_s", "vr_s")
                                          if k in stats]
    return torch.cat([p.double() for p in parts])


def _stats_from_table(table: torch.Tensor, template) -> dict:
    """The global stats from [n_accum, n] sums of the ranks' stat vectors:
    each chunk's psnrs from its mses, then the mean over chunks of each."""
    per_chunk = []
    for row in table.to(torch.float32):
        stats, i = {"loss": row[0]}, 1
        stats["loss_terms"] = {}
        for k in template["loss_terms"]:
            stats["loss_terms"][k], i = row[i], i + 1
        n_levels = template["mses"].numel()
        stats["mses"], i = row[i:i + n_levels], i + n_levels
        for k in ("rm_s", "vr_s"):
            if k in template:
                stats[k], i = row[i], i + 1
        stats["psnrs"] = metrics_lib.mse_to_psnr(stats["mses"])
        stats["psnr"] = stats["psnrs"][-1]
        per_chunk.append(stats)
    return _mean_stats(per_chunk)


def make_train_step(config: Config, model, optimizer, lr_fn, cameras=None,
                    camtype: str = "perspective"):
    """Returns step(batch, step_index, train_frac, generator=None) -> stats.

    `batch` lives on the model's device. A batch of `Pixels` is cast to rays
    there with `cameras` (tensors on the same device). `step_index` counts
    the updates made so far and sets the learning rate. An NGP model marches
    through its `occupancy` buffer. With `grad_accum_steps` K > 1 the batch
    is cut into K equal chunks in order, the chunks' gradients are summed
    and divided by K before one Adam update, and each stat is the mean over
    the chunks.

    In a process group (`parallel.mesh.active()`) `batch` is this rank's
    rows of the global batch, and the step equals the reference's step on
    the global batch, whose losses average over the whole sharded batch.
    Each rank's loss is its share of the global loss (`Share`: the
    lossmult sum and the count of valid depths are summed over the ranks
    before the forward, as they depend on no parameter), its draws are its
    rows of the global batch's (`parallel.mesh.row_shard`), and after the
    backward one flat all-reduce sums the gradients: the reference's
    all-reduce, which reverse-mode AD emits. An explicit all-reduce, not
    DistributedDataParallel: DDP would average the gradients and hook the
    backward, which the Ref-NeRF density normal (`autograd.grad` inside the
    forward), unused GLO rows and the remat checkpoint all cross. The
    gradient norm, clipping and `nan_to_num` follow the sum, and the stats
    are global (each accumulation chunk's psnr from its global mse).
    Accumulation chunks are the reference's chunks of the global batch
    (`chunk_layout`). Jitter and noise draws of a chunk spread over several
    ranks equal one process's draws for that chunk; where every chunk lies
    on one rank, a rank's i-th chunk draws as a single process's i-th chunk
    would, so those draws differ from one process's. The NGP hash-table
    gradient is each rank's sorted row sums over its own samples (K2a runs
    per rank), and the all-reduce is the reference's psum of shard-local
    row sums (`ops/hashgrid.py:set_grad_mesh`); no switch is needed.

    Under a profiler the phases are marked (`utils/tracing.py`): `step.cast`,
    `step.forward`, `step.loss`, `step.backward` and `step.optimizer` (the
    all-reduce, norm, clip, `nan_to_num` and Adam); an NGP step counts its
    rendered samples (`ngp.samples` over `ngp.rays`).
    """
    compute_extras = config.lambda_depth > 0 and config.depth_loss_type in (
        "mse", "l1", "urf", "nll"
    )
    params = list(model.parameters())
    forward = make_forward(config, model, compute_extras)
    remat = _remat_on(config)
    decayed = _decayed_params(config, model)
    n_accum = max(1, config.grad_accum_steps)

    def chunk_backward(batch, rays, train_frac, generator, share):
        """Forward, loss and backward of one chunk; its stats."""
        with tracing.span("step.forward"):
            renderings, ray_history = forward(rays, train_frac, generator)
        after = None if generator is None or not remat else generator.get_state()
        with tracing.span("step.loss"):
            loss_terms, stats = _total_loss(config, batch, renderings, ray_history, rays, share)
            if config.weight_decay_mults:
                weight = sum(
                    (mult * sum(torch.sum(p**2) for p in ps) for mult, ps in decayed),
                    torch.zeros((), device=stats["psnr"].device))
                loss_terms["weight"] = weight if share is None else weight * share.rays
            total = sum(loss_terms.values())
        with tracing.span("step.backward"):
            total.backward()
        if after is not None:
            generator.set_state(after)
        stats["loss_terms"] = {k: v.detach() for k, v in loss_terms.items()}
        stats["loss"] = total.detach()
        return stats

    def chunks_backward(batch, rays, train_frac, generator):
        """Each of this rank's chunks forward and backward as its share of
        the reference's chunk; the summed stats of every chunk. Without a
        process group this is one process's step: the layout is the n
        chunks in order, each share is the whole chunk, and the all-reduces
        do nothing."""
        layout = chunk_layout(n_accum, parallel.make_mesh())
        pieces = list(zip(layout.chunk_ids, _chunks(batch, layout.n_local),
                          _chunks(rays, layout.n_local)))
        device = batch.rgb.device
        sums = torch.zeros((n_accum, 2), dtype=torch.float64, device=device)
        for cid, c_batch, c_rays in pieces:
            sums[cid] += _denominators(c_batch, c_rays)
        parallel.all_reduce_sum_([sums])
        table, template = None, None
        for cid, c_batch, c_rays in pieces:
            share = Share(1.0 / layout.count, sums[cid, 0].float(), sums[cid, 1].float())
            with parallel.row_shard(layout.index, layout.count):
                template = chunk_backward(c_batch, c_rays, train_frac, generator, share)
            vec = _stat_vector(template)
            if table is None:
                table = torch.zeros((n_accum, vec.numel()), dtype=torch.float64, device=device)
            table[cid] += vec
        parallel.all_reduce_sum_([table])
        return _stats_from_table(table, template)

    def step(batch, step_index: int, train_frac: float, generator=None):
        rays = batch.rays
        if isinstance(rays, rays_lib.Pixels):
            with tracing.span("step.cast"):
                rays = cameras_lib.cast_pixels(rays, cameras, camtype)
        generator = generator if config.randomized else None
        optimizer.zero_grad(set_to_none=False)
        stats = chunks_backward(batch, rays, train_frac, generator)
        if "vr_s" in stats:
            # The step's mean rendered samples a ray, kept on the device.
            n_rays = batch.rgb.shape[0]
            tracing.count("ngp.samples", stats["vr_s"], n_rays)
            tracing.count("ngp.rays", n_rays)
        with tracing.span("step.optimizer"):
            with torch.no_grad():
                for p in params:
                    if p.grad is None:  # unused this step: a zero gradient
                        p.grad = torch.zeros_like(p)
                parallel.all_reduce_sum_([p.grad for p in params])
                if n_accum > 1:
                    for p in params:
                        p.grad.div_(n_accum)
                stats["grad_norm"] = global_norm([p.grad for p in params])
                clip_gradients(model, config)
                for p in params:
                    torch.nan_to_num_(p.grad)
            for group in optimizer.param_groups:
                group["lr"] = lr_fn(step_index)
            optimizer.step()
        return stats

    return step


def _grid_kwargs(model) -> dict:
    """The occupancy grid an NGP model marches through; nothing for others."""
    return {"occupancy": model.occupancy} if isinstance(model, HashGridModel) else {}


def make_occupancy_update_fn(config: Config, model):
    """The NGP occupancy-grid refresh; None for models without a grid.

    Returns update(grid, generator, warmup) -> new grid. A warmup refresh
    sweeps every cell, a later one `occupancy_cells_per_update` sampled
    cells per cascade. In a process group every rank calls it, and every
    rank gets rank 0's grid. Packed hash tables are built once per refresh,
    not once per chunk of the sweep (the osplit layout packs none: its
    forward reads the canonical table).
    """
    if not isinstance(model, HashGridModel):
        return None

    @torch.no_grad()
    def update(grid, generator, warmup: bool):
        density_fn = make_density_fn(model, model.prepare_tables())
        grid = occ_lib.update_grid(
            grid, density_fn, model.scale, decay=config.occupancy_decay,
            n_per_cascade=0 if warmup else config.occupancy_cells_per_update,
            threshold=model.density_threshold, generator=generator,
        )
        # The grid is replicated. Every rank refreshes it from the same
        # parameters and generator state; rank 0's copy is broadcast so the
        # ranks hold it bit for bit whatever order the card sums in.
        parallel.broadcast_([grid])
        return grid

    return update


@torch.no_grad()
def render_image(model, batch, chunk_size: int = 16384, device=None,
                 ngp_eval_renderer: str = "train"):
    """Render a full image ([H, W] rays) in chunks; returns numpy [H, W, ...].

    Deterministic (no jitter, train_frac 1) with every extra; the per-ray
    outputs of the finest level (not the `ray_*` arrays of a few rays). A
    mip-NeRF 360 model renders without its GLO and exposure embeddings
    (`zero_glo`) and takes its density normals under grad mode locally. An
    NGP model marches through its grid: with the train path's dense
    renderer, or with `render_eval` when `ngp_eval_renderer` is "iterative"
    (the port's NGP model always carries its grid, so no call is gridless).

    In a process group every rank calls it with the whole image: each chunk
    is edge-padded to a multiple of the world size, each rank renders its
    rows (the NGP batch plan spans the chunk, `parallel.row_shard`), the
    rows are gathered in rank order and the padding trimmed, so every rank
    returns the image one process renders.

    Under a profiler it marks `render.image`, holding a `render.chunk` a chunk
    (`render.copy_in`, the model's spans, `render.copy_out`) and then
    `render.assemble`; an NGP model's chunks count their samples
    (`ngp.samples` over `ngp.rays`, from the host copy).
    """
    with tracing.span("render.image"):
        device = device or next(model.parameters()).device
        ngp = isinstance(model, HashGridModel)
        iterative = ngp and ngp_eval_renderer == "iterative"
        mesh_ = parallel.make_mesh()
        distributed = parallel.active()
        rays = batch.rays
        h, w = rays.origins.shape[:2]
        flat = rays_lib.map_fields(lambda r: r.reshape((h * w,) + r.shape[2:]), rays)
        outs = []
        for start in range(0, h * w, chunk_size):
            with tracing.span("render.chunk"):
                outs.append(_render_chunk(model, flat, start, chunk_size, device, iterative,
                                          mesh_, distributed))
                if ngp:
                    tracing.count("ngp.samples", outs[-1]["samples_per_ray"])
                    tracing.count("ngp.rays", outs[-1]["samples_per_ray"].shape[0])
        with tracing.span("render.assemble"):
            return {
                k: torch.cat([o[k] for o in outs]).reshape((h, w) + outs[0][k].shape[1:]).numpy()
                for k in outs[0]
            }


def _render_chunk(model, flat, start: int, chunk_size: int, device, iterative: bool, mesh_,
                  distributed: bool) -> dict:
    """The finest level's per-ray outputs of rays [start, start + chunk_size) on the host."""
    with tracing.span("render.copy_in"):
        chunk = rays_lib.map_fields(lambda r: r[start : start + chunk_size], flat)
        pad = 0
        if distributed:
            chunk, pad = rays_lib.pad_to_multiple(chunk, mesh_.size)
            chunk = parallel.shard_batch(chunk, mesh_)
        chunk = rays_lib.to_device(chunk, device)
    with (parallel.row_shard(mesh_.rank, mesh_.size) if distributed
          else contextlib.nullcontext()):
        if iterative:
            final = model.render_eval(chunk, model.occupancy)
        else:
            renderings, _ = model(chunk, train_frac=1.0, compute_extras=True,
                                  **_grid_kwargs(model))
            final = renderings[-1]
    final = {k: v for k, v in final.items() if not k.startswith("ray_")}
    if distributed:
        final = {k: parallel.all_gather_rows(v) for k, v in final.items()}
        final = {k: v[: v.shape[0] - pad] for k, v in final.items()}
    with tracing.span("render.copy_out"):
        return {k: v.cpu() for k, v in final.items()}
