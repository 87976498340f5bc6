"""Unified configuration: one dataclass, `key=value` overrides, JSON files.

A copy of the reference package's `train/config.py`: the same fields and
defaults, so every `configs/*.json` loads unchanged. Fields of options the
port has not reached yet are kept and rejected where they would take effect
(`train/step.py:check_supported`). Overrides are
`key=value` strings (ints/floats/bools/None/json parsed by value), files are
JSON dicts; model-specific hyperparameters ride in `model_params`,
`nerf_mlp_params`, `prop_mlp_params` dicts.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class Config:
    # -- experiment
    exp_dir: str = "exp/default"
    seed: int = 0

    # -- data
    dataset: str = "synthetic"  # synthetic | driving | nerfpp
    scene_dir: str = ""
    factor: int = 0
    near: float = 0.1
    far: float = 150.0
    auto_adjust_near_far: bool = True
    sample_every: int = 1  # sparse-view protocol: keep every k-th train view
    batch_size: int = 4096  # global rays per step
    patch_size: int = 1
    cast_rays_in_train_step: bool = True
    use_native_batcher: bool = True  # C++ dataplane when buildable
    depth_sup_type: str = "gt"  # gt | stereo_crop | mono_crop | mff_crop | rgbonly
    depth_crop_range: float = 0.0
    depth_keep_ratio: float = 0.0

    # -- model
    model: str = "mipnerf360"  # mipnerf360 | nerfpp | ngp
    model_params: Any = dataclasses.field(default_factory=dict)
    nerf_mlp_params: Any = dataclasses.field(default_factory=dict)
    prop_mlp_params: Any = dataclasses.field(default_factory=dict)
    compute_dtype: str = "float32"  # float32 | bfloat16 (bfloat16 not ported yet)

    # -- losses
    data_loss_type: str = "mse"  # mse | charb | rawnerf
    charb_padding: float = 0.001
    data_loss_mult: float = 1.0
    data_coarse_loss_mult: float = 0.0
    depth_loss_type: str = "mse"  # mse | l1 | kl | urf | nll
    lambda_depth: float = 0.0  # 0 disables depth supervision (rgbonly)
    depth_sigma: float = 1.0  # kl/urf uncertainty, in metres (pre-scale)
    depth_loss_reduce: str = "mean_all"  # mean_all (mip) | mean_valid (nerf++)
    depth_fg_far_mask: bool = False  # NeRF++: drop supervision past sphere
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.01
    opacity_loss_mult: float = 0.0
    autoexpo_loss_mult: float = 0.0
    orientation_loss_mult: float = 0.0
    orientation_coarse_loss_mult: float = 0.0
    orientation_loss_target: str = "normals_pred"
    predicted_normal_loss_mult: float = 0.0
    predicted_normal_coarse_loss_mult: float = 0.0
    weight_decay_mults: Any = dataclasses.field(default_factory=dict)

    # -- NGP occupancy grid (the NGP model is not ported yet)
    # Eval renderer for the NGP model: "train" = reuse the dense train-path
    # renderer; "iterative" = occupancy-aware alive-ray marching.
    ngp_eval_renderer: str = "train"
    occupancy_update_every: int = 16
    occupancy_warmup_steps: int = 256
    occupancy_decay: float = 0.95
    occupancy_cells_per_update: int = 65536  # sampled cells per cascade

    # -- optimization
    max_steps: int = 75_000
    lr_init: float = 2e-3
    lr_final: float = 2e-5
    lr_delay_steps: int = 512
    lr_delay_mult: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-6
    grad_max_norm: float = 0.001
    grad_max_val: float = 0.0
    randomized: bool = True
    # Recompute the forward during backward instead of holding activations:
    # "dots" keeps matmul outputs, "full" keeps nothing.
    remat: str = "none"  # none | full | dots
    # Microbatching: split each step's rays into K sequential chunks,
    # accumulate gradients, apply adam once.
    grad_accum_steps: int = 1
    # Dispatch fusion: K optimizer steps per dispatch of the reference's
    # compiled program; the same math as K sequential steps.
    steps_per_dispatch: int = 1

    # -- depth bookkeeping
    depth_scale: float = 1.0  # filled by the loader (pose-normalization scale)

    # -- profiling
    profile_start_step: int = 0  # 0 disables the profiler trace
    profile_num_steps: int = 5

    # -- logging / eval / checkpoints
    print_every: int = 100
    checkpoint_every: int = 5000
    keep_checkpoints: int = 3
    # Params-only "slim" checkpoint: when set, eval restores from this file
    # instead of exp_dir's checkpoints (checkpoints are not ported yet).
    slim_checkpoint: str = ""
    train_render_every: int = 0
    render_chunk_size: int = 16384
    eval_depth_cap: float = 80.0
    compute_ssim: bool = True
    compute_lpips: bool = False
    vis_num_rays: int = 16

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _parse_value(raw: str):
    lowered = raw.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw and raw[0] in "[{":
        return json.loads(raw)
    return raw


def load_config(
    path: Optional[str] = None, overrides: Sequence[str] = ()
) -> Config:
    """Build a Config from an optional JSON file plus key=value overrides."""
    values = {}
    if path:
        with open(path) as f:
            values.update(
                {k: v for k, v in json.load(f).items() if not k.startswith("_")}
            )
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, raw = item.split("=", 1)
        key = key.strip().lstrip("-")
        values[key] = _parse_value(raw.strip())
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = set(values) - known
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return Config(**values)


def save_config(config: Config, path: str):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, default=str)
