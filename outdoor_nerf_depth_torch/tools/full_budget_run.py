"""Quality runs on the KITTI fixture: train each backend, evaluate the test split.

    python -m outdoor_nerf_depth_torch.tools.full_budget_run \\
        [backends=mip,ngp,nerfpp] [steps_scale=1.0] [fixture=build/kitti_fixture] \\
        [exp_root=build/full_budget] [out=build/quality_full.json] \\
        [stop_at=N] [--device cpu] [key=value ...]

Trains mip-NeRF 360 (`configs/kitti_mipnerf360.json`, 75k steps at full
budget) and Instant-NGP (`configs/kitti_ngp.json`, 30k steps) on the
KITTI-layout fixture's COLMAP scene, and NeRF++ (`configs/kitti_nerfpp.json`,
100k steps) on its NeRF++ layout, `steps_scale` times those budgets, then
evaluates the test split (views 9, 19, 29 of 30). `backends` defaults to
mip and ngp. `stop_at` ends each run after that
many steps of its schedule, as a run cut short would end. The fixture is
written with the port's own tool (`tools/make_kitti_fixture.py`, 30 views
of 94x310) when `fixture` holds none. Any other `key=value` is forwarded to
every backend's config, after the tool's own overrides.

Runs resume: each backend trains in `exp_root/<backend>`, and the train
loop restores its latest checkpoint; a run whose checkpoint is already at
its step count trains nothing and is evaluated as it stands. After each
backend the results go to `out`, one entry per run with the test split's
mean metrics, the train PSNR curve, train and eval seconds, the step the
segment resumed from, the steps it trained and its train rays/s; the
`device` field names the card and its power limit. Runs on CUDA unless
`--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from outdoor_nerf_depth_torch.tools import make_kitti_fixture
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device, train

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = {
    "mip": dict(config=os.path.join(REPO, "configs", "kitti_mipnerf360.json"),
                scene_sub="dtu_format", steps=75000),
    "ngp": dict(config=os.path.join(REPO, "configs", "kitti_ngp.json"),
                scene_sub="dtu_format", steps=30000),
    "nerfpp": dict(config=os.path.join(REPO, "configs", "kitti_nerfpp.json"),
                   scene_sub="nerfpp", steps=100000),
}


def ensure_fixture(path: str, n_images: int = 30):
    if not os.path.isdir(os.path.join(path, "dtu_format", "sparse")):
        make_kitti_fixture.main(path, n_images)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def check_backend(name: str):
    if name not in RUNS:
        raise ValueError(f"unknown backend {name!r}; expected one of {sorted(RUNS)}")


def run_backend(name: str, fixture: str, exp_root: str, steps_scale: float,
                extra_overrides=(), device=None, stop_at=None):
    check_backend(name)
    spec = RUNS[name]
    steps = max(100, round(spec["steps"] * steps_scale))
    config = load_config(
        spec["config"],
        [
            f"scene_dir={os.path.join(fixture, spec['scene_sub'])}",
            f"exp_dir={os.path.join(exp_root, name)}",
            f"max_steps={steps}",
            "print_every=500",
            "train_render_every=0",
            "compute_ssim=true",
            *extra_overrides,
        ],
    )
    # Throughput counts only the steps this segment trained.
    resumed_from = ckpt_lib.latest_step(os.path.join(config.exp_dir, "checkpoints")) or 0
    t0 = time.perf_counter()
    model, history = train(config, device=device, max_steps=stop_at)
    train_s = time.perf_counter() - t0
    trained = stop_at or config.max_steps
    steps_this_segment = max(0, trained - min(resumed_from, trained))

    t0 = time.perf_counter()
    mean, _ = evaluate(config, model, device=device)
    eval_s = time.perf_counter() - t0

    curve = [
        {"step": h["step"], "psnr": round(float(h["psnr"]), 3), "loss": round(float(h["loss"]), 5)}
        for h in history
        if h["step"] % 2500 == 0 or h is history[-1]
    ]
    return {
        "backend": name,
        "steps": trained,
        "schedule_steps": config.max_steps,
        "batch": config.batch_size,
        "overrides": list(extra_overrides),
        "metrics": {k: round(float(v), 4) for k, v in mean.items()},
        "train_psnr_curve": curve,
        "final_train_psnr": round(float(history[-1]["psnr"]), 3) if history else None,
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        "resumed_from_step": resumed_from,
        "steps_this_segment": steps_this_segment,
        "rays_per_sec_train": round(
            config.batch_size * steps_this_segment / max(train_s, 1e-9), 1
        ) if history else None,
    }


def main(argv):
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    device = resolve_device(device)
    kv = dict(a.split("=", 1) for a in argv)
    backends = kv.pop("backends", "mip,ngp").split(",")
    out = kv.pop("out", os.path.join(REPO, "build", "quality_full.json"))
    fixture = kv.pop("fixture", os.path.join(REPO, "build", "kitti_fixture"))
    exp_root = kv.pop("exp_root", os.path.join(REPO, "build", "full_budget"))
    steps_scale = float(kv.pop("steps_scale", 1.0))
    stop_at = int(kv.pop("stop_at", 0)) or None
    extra = tuple(f"{k}={v}" for k, v in kv.items())
    for name in backends:
        check_backend(name)

    ensure_fixture(fixture)
    results = {"device": device_label(device), "steps_scale": steps_scale, "runs": []}
    if os.path.isfile(out):
        with open(out) as f:
            prior = json.load(f)
        # Keep the other backends' entries of a partial artifact.
        results["runs"] = [r for r in prior.get("runs", []) if r["backend"] not in backends]
    for name in backends:
        print(f"=== full-budget run: {name} ===", flush=True)
        r = run_backend(name, fixture, exp_root, steps_scale, extra, device, stop_at)
        results["runs"].append(r)
        if os.path.dirname(out):
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
        print(json.dumps(r), flush=True)
    print(json.dumps({"out": out, "n_runs": len(results["runs"])}))


if __name__ == "__main__":
    main(sys.argv[1:])
