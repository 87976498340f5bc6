"""End-to-end prior -> NeRF chain on the KITTI fixture.

    python -m outdoor_nerf_depth_torch.tools.e2e_prior_loop \\
        [out=build/e2e_prior.json] [fixture=build/kitti_fixture] [work=build/e2e_prior] \\
        [prior_steps=400] [prior_seed=0] [nerf_steps=3000] [sample_every=4] \\
        [backend=mip|ngp] [stages=all|prior|nerf] [--device cpu] [key=value ...]

The port's counterpart of the repository's `tools/e2e_prior_loop.py`, in
its four stages:

  1. a depth-completion training set from the fixture scene: `image/`, the
     scene's images; `sparse/`, 5% of the metric depth kept with
     `default_rng(3)` (the LiDAR pattern a completion net sees as input);
     `groundtruth/`, the dense metric depth;
  2. `GuidedCompletionNet` trained on it for `prior_steps` at crop 64x192,
     batch 2, from initial weights of seed `prior_seed` (`train_prior
     complete --seed`; the reference's fixed init is seed 0);
  3. `depths_mffgen_crop/` written into the scene by
     `generate_completion_priors`, with its RMSE and density against
     `depths_gt`;
  4. the NeRF trained with `depth_sup_type=mffgen_crop`, then as "rgbonly":
     `depth_sup_type=gt` with `lambda_depth=0.0`, so the loader keeps the
     gt depth and the eval its depth column; both evaluated on the test
     split.

At lr 1e-3 the prior collapses for many initialisations (its output ReLU
dies and every pixel is 0), in the reference package too. A prior of
density 0 supervises nothing, so stage 4 raises on one instead of training
two rgbonly legs; `prior_seed=` picks another initialisation.

It writes the reference tool's JSON keys to `out`, plus `device`, the card's
name and power limit. `stages=prior` stops after the PNGs; `stages=nerf`
runs only the NeRF legs on PNGs already written, and reuses a leg already
in `out` at the same step count. Any other `key=value` is forwarded to both
NeRF legs' configs (e.g. small `model_params` for a CPU rehearsal). The
fixture is written with the port's own tool (30 views of 94x310) when
`fixture` holds none. Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from outdoor_nerf_depth_torch.data.datasets import load_image
from outdoor_nerf_depth_torch.depth_priors import generate
from outdoor_nerf_depth_torch.tools import full_budget_run, train_prior
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device, train
from outdoor_nerf_depth_torch.utils.image import save_depth_u16

REPO = full_budget_run.REPO
NERF_CONFIGS = {
    "mip": os.path.join(REPO, "configs", "kitti_mipnerf360.json"),
    "ngp": os.path.join(REPO, "configs", "kitti_ngp.json"),
}
PRIOR_NAME = "mffgen_crop"  # folder: depths_mffgen_crop


def build_completion_data(scene: str, work: str, density: float = 0.05, seed: int = 3):
    """The KITTI-completion layout from the fixture scene: `sparse/` keeps a
    random ~`density` of the metric depth, `groundtruth/` all of it."""
    root = os.path.join(work, "completion_data")
    for sub in ("image", "sparse", "groundtruth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(scene, "images")
    for name in sorted(os.listdir(img_dir)):
        shutil.copyfile(os.path.join(img_dir, name), os.path.join(root, "image", name))
        depth = load_image(os.path.join(scene, "depths_gt", name)) / 256.0
        keep = rng.uniform(size=depth.shape) < density
        save_depth_u16(np.where(keep, depth, 0.0), os.path.join(root, "sparse", name))
        save_depth_u16(depth, os.path.join(root, "groundtruth", name))
    return root


def train_completion(data_root: str, work: str, steps: int, device: torch.device,
                     seed: int = 0):
    params_path = os.path.join(work, "completion_params.pt")
    train_prior.main([
        "complete", "--data", data_root, "--arch", "guided", "--steps", str(steps),
        "--batch", "2", "--crop", "64", "192", "--out", params_path,
        "--print-every", str(max(steps // 8, 1)), "--seed", str(seed), "--device", str(device),
    ])
    return params_path


def generate_priors(scene: str, params_path: str, work: str, device: torch.device):
    out_dir = os.path.join(scene, f"depths_{PRIOR_NAME}")
    generate.generate_completion_priors(
        torch.load(params_path, map_location="cpu", weights_only=True),
        image_dir=os.path.join(scene, "images"),
        sparse_depth_dir=os.path.join(work, "completion_data", "sparse"),
        out_dir=out_dir, arch="guided", device=device,
    )
    return out_dir


def prior_quality(scene: str):
    """Depth RMSE (m) of the generated PNGs against gt where both are
    positive, mean over the views that have such pixels (None when no view
    has), and the PNGs' density."""
    gt_dir = os.path.join(scene, "depths_gt")
    pr_dir = os.path.join(scene, f"depths_{PRIOR_NAME}")
    errs, density = [], []
    for name in sorted(os.listdir(gt_dir)):
        gt = load_image(os.path.join(gt_dir, name)) / 256.0
        pr = load_image(os.path.join(pr_dir, name)) / 256.0
        m = (gt > 0) & (pr > 0)
        if m.any():
            errs.append(float(np.sqrt(np.mean((gt[m] - pr[m]) ** 2))))
        density.append(float((pr > 0).mean()))
    return {"prior_rmse_m": round(float(np.mean(errs)), 4) if errs else None,
            "prior_density": round(float(np.mean(density)), 4)}


def run_nerf(scene: str, work: str, backend: str, sup_type: str, steps: int,
             sample_every: int, extra=(), device=None):
    sup_overrides = (["depth_sup_type=gt", "lambda_depth=0.0"] if sup_type == "rgbonly"
                     else [f"depth_sup_type={sup_type}"])
    config = load_config(NERF_CONFIGS[backend], [
        f"scene_dir={scene}",
        f"exp_dir={os.path.join(work, f'{backend}_{sup_type}')}",
        f"max_steps={steps}",
        *sup_overrides,
        f"sample_every={sample_every}",
        "print_every=500",
        "train_render_every=0",
        "checkpoint_every=100000",  # no mid-run checkpoints for short legs
        "compute_ssim=true",
        *extra,
    ])
    t0 = time.perf_counter()
    model, _ = train(config, device=device)
    train_s = time.perf_counter() - t0
    mean, _ = evaluate(config, model, device=device)
    return {"depth_sup_type": sup_type, "steps": steps,
            "metrics": {k: round(float(v), 4) for k, v in mean.items()},
            "train_seconds": round(train_s, 1)}


def _write(out: str, results: dict):
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)


def main(argv):
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    device = resolve_device(device)
    kv = dict(a.split("=", 1) for a in argv)
    out = kv.pop("out", os.path.join(REPO, "build", "e2e_prior.json"))
    fixture = kv.pop("fixture", os.path.join(REPO, "build", "kitti_fixture"))
    work = kv.pop("work", os.path.join(REPO, "build", "e2e_prior"))
    prior_steps = int(kv.pop("prior_steps", 400))
    prior_seed = int(kv.pop("prior_seed", 0))
    nerf_steps = int(kv.pop("nerf_steps", 3000))
    sample_every = int(kv.pop("sample_every", 4))
    backend = kv.pop("backend", "mip")
    stages = kv.pop("stages", "all")
    if backend not in NERF_CONFIGS or stages not in ("all", "prior", "nerf"):
        raise ValueError(f"backend {backend!r} or stages {stages!r} unknown")
    extra = tuple(f"{k}={v}" for k, v in kv.items())

    full_budget_run.ensure_fixture(fixture)
    scene = os.path.join(fixture, "dtu_format")
    os.makedirs(work, exist_ok=True)
    results = {}
    if os.path.isfile(out):
        with open(out) as f:
            results = json.load(f)
    results["device"] = full_budget_run.device_label(device)

    if stages in ("all", "prior"):
        data_root = build_completion_data(scene, work)
        t0 = time.perf_counter()
        params_path = train_completion(data_root, work, prior_steps, device, prior_seed)
        results["prior_train_seconds"] = round(time.perf_counter() - t0, 1)
        generate_priors(scene, params_path, work, device)
        results.update(prior_quality(scene))
        results["prior_steps"] = prior_steps
        results["prior_seed"] = prior_seed
        _write(out, results)
        print(json.dumps({k: results[k] for k in ("prior_rmse_m", "prior_density")}), flush=True)

    if stages in ("all", "nerf"):
        if not os.path.isdir(os.path.join(scene, f"depths_{PRIOR_NAME}")):
            raise FileNotFoundError(f"run stages=prior first: no depths_{PRIOR_NAME} in {scene}")
        if prior_quality(scene)["prior_density"] == 0.0:
            raise RuntimeError(f"the depths_{PRIOR_NAME} prior in {scene} is all zero (it "
                               "collapsed in training): it would supervise nothing; train "
                               "another with stages=prior prior_seed=...")
        cached = {r["depth_sup_type"]: r for r in results.get("nerf_runs", [])
                  if r.get("metrics", {}).get("rmse") is not None and r.get("steps") == nerf_steps}
        runs = []
        for sup in (PRIOR_NAME, "rgbonly"):
            if sup in cached:
                print(f"=== nerf leg: {sup}: cached ===", flush=True)
                runs.append(cached[sup])
                continue
            print(f"=== nerf leg: {sup} ===", flush=True)
            runs.append(run_nerf(scene, work, backend, sup, nerf_steps, sample_every, extra,
                                 device))
            results["nerf_runs"] = runs
            _write(out, results)
        rmse = {r["depth_sup_type"]: r["metrics"].get("rmse") for r in runs}
        results["prior_beats_rgbonly_rmse"] = bool(rmse[PRIOR_NAME] < rmse["rgbonly"])
        results["backend"] = backend
        results["sample_every"] = sample_every
        _write(out, results)
        print(json.dumps({"rmse": rmse,
                          "prior_beats_rgbonly_rmse": results["prior_beats_rgbonly_rmse"]}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
