"""Quality gate: every backend must converge, not just run.

    python -m outdoor_nerf_depth_torch.tools.quality_gate \\
        [backends=mipnerf360,nerfpp,ngp] [steps_scale=1.0] [out=QUALITY.json] \\
        [exp_root=build/quality_gate] [--device cpu]

The port's counterpart of the repository's `quality_gate.py`, with its
gates: each backend trains on the analytic sphere scene
(`SphereSceneDataset`, exact depth) for its step budget times
`steps_scale`, evaluates the held-out views (PSNR, SSIM, the capped depth
battery; the renders are saved), and must reach its PSNR and depth-RMSE
thresholds. Results go to `out` as JSON (the reference's keys, plus each
gate's median host ms per step after the first logged interval); the exit
code is 1 when a gate fails. The `device` field names the card and its power limit as nvidia-smi
gives them. Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from outdoor_nerf_depth_torch.tools.eval import split_flags
from outdoor_nerf_depth_torch.tools.full_budget_run import device_label
from outdoor_nerf_depth_torch.train.config import Config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device, train

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The reference gate's budgets, thresholds and configs. The analytic scene
# is easy enough that a healthy backend clears the thresholds with margin,
# and a silent regression (sampling, losses, compositing, depth
# bookkeeping) lands well below.
GATES = {
    "mipnerf360": dict(
        steps=3000,
        batch=4096,
        thresholds=dict(psnr=26.0, rmse=0.10),
        config=dict(
            model="mipnerf360",
            model_params=dict(
                num_prop_samples=64,
                num_nerf_samples=32,
                num_levels=3,
                # The analytic scene's background is black.
                bg_intensity_range=(0.0, 0.0),
                nerf_mlp_params=dict(net_depth=4, net_width=256, bottleneck_width=128),
                prop_mlp_params=dict(net_depth=4, net_width=128),
            ),
            lambda_depth=0.05,
            depth_loss_type="mse",
            near=0.05,
            far=4.0,
            lr_init=2e-3,
            lr_final=2e-4,
            lr_delay_steps=128,
        ),
    ),
    "nerfpp": dict(
        steps=3000,
        batch=2048,
        thresholds=dict(psnr=24.0, rmse=0.15),
        config=dict(
            model="nerfpp",
            model_params=dict(
                cascade_samples=(32, 64),
                net_depth=4,
                net_width=128,
                pos_degrees=10,
                view_degrees=4,
            ),
            lambda_depth=0.05,
            depth_loss_type="mse",
            depth_loss_reduce="mean_valid",
            data_coarse_loss_mult=1.0,
            interlevel_loss_mult=0.0,
            distortion_loss_mult=0.0,
            near=0.05,
            far=4.0,
            lr_init=1e-3,
            lr_final=1e-4,
            lr_delay_steps=128,
        ),
    ),
    "ngp": dict(
        steps=600,
        batch=4096,
        thresholds=dict(psnr=26.0, rmse=0.10),
        config=dict(
            model="ngp",
            model_params=dict(
                scale=0.5,
                max_samples=64,
                n_candidates=256,
            ),
            lambda_depth=0.05,
            depth_loss_type="mse",
            interlevel_loss_mult=0.0,
            distortion_loss_mult=0.0,
            opacity_loss_mult=1e-3,
            occupancy_update_every=16,
            occupancy_warmup_steps=256,
            near=0.05,
            far=4.0,
            lr_init=1e-2,
            lr_final=1e-3,
            lr_delay_steps=128,
            grad_max_norm=0.0,
        ),
    ),
}


def gate_config(name: str, exp_root: str, steps_scale: float = 1.0) -> Config:
    gate = GATES[name]
    steps = max(10, int(gate["steps"] * steps_scale))
    return Config(
        dataset="spheres",
        batch_size=gate["batch"],
        max_steps=steps,
        print_every=max(50, steps // 10),
        checkpoint_every=steps,
        train_render_every=0,
        compute_ssim=True,
        render_chunk_size=8192,
        # K steps per loop iteration, as the reference gate dispatches them.
        steps_per_dispatch=8,
        exp_dir=os.path.join(exp_root, name),
        **gate["config"],
    )


def run_gate(name: str, exp_root: str, steps_scale: float = 1.0, device=None):
    gate = GATES[name]
    config = gate_config(name, exp_root, steps_scale)
    t0 = time.perf_counter()
    model, history = train(config, device=device)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mean, _ = evaluate(config, model, device=device, save_renders=True)
    eval_s = time.perf_counter() - t0

    th = gate["thresholds"]
    passed = mean["psnr"] >= th["psnr"] and mean["rmse"] <= th["rmse"]
    # Host ms per step of each logged interval; the first holds the warmup.
    step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
    return {
        "backend": name,
        "steps": config.max_steps,
        "batch": gate["batch"],
        "passed": bool(passed),
        "thresholds": th,
        "metrics": {k: round(float(v), 4) for k, v in mean.items()},
        "final_train_psnr": round(history[-1]["psnr"], 3) if history else None,
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        "median_step_ms": round(statistics.median(step_ms[1:] or step_ms), 3) if history else None,
    }


def main(argv):
    device, _, argv = split_flags(argv)
    device = resolve_device(device)
    kv = dict(a.split("=", 1) for a in argv)
    backends = kv.get("backends", "mipnerf360,nerfpp,ngp").split(",")
    steps_scale = float(kv.get("steps_scale", 1.0))
    out = kv.get("out", "QUALITY.json")
    exp_root = kv.get("exp_root", os.path.join(REPO, "build", "quality_gate"))
    for name in backends:
        if name not in GATES:
            raise ValueError(f"unknown backend {name!r}; expected one of {sorted(GATES)}")

    results = {
        "device": device_label(device),
        "n_devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "steps_scale": steps_scale,
        "gates": [],
    }
    for name in backends:
        print(f"=== gate: {name} ===", flush=True)
        r = run_gate(name, exp_root, steps_scale, device)
        results["gates"].append(r)
        print(json.dumps(r), flush=True)

    results["all_passed"] = all(g["passed"] for g in results["gates"])
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"all_passed": results["all_passed"], "out": out}))
    return 0 if results["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
