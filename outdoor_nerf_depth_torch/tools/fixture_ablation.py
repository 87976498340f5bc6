"""The paper's Table 6 ablation on the KITTI fixture: depth loss x prior.

    python -m outdoor_nerf_depth_torch.tools.fixture_ablation \\
        [out=build/sweep_ablation.json] [fixture=build/kitti_fixture] \\
        [exp_root=build/fixture_ablation] [steps=2000] [sample_every=4] \\
        [backend=mip] [--device cpu] [key=value ...]

The port's counterpart of the repository's `tools/fixture_ablation.py`.
Trains and evaluates one backend (`mip`, `ngp` or `nerfpp`) on the
fixture (written by `tools/make_kitti_fixture.py` when `fixture` holds
none) at sparse views, for each depth loss {mse, l1, kl} under each prior
{gt, stereo_crop, mono_crop}, and once without depth supervision
(`rgbonly`: `lambda_depth=0` with `depth_sup_type=gt`, so the test views
keep their ground-truth depth for the depth metrics). `out` gets the
structure of the reference's `SWEEP_ABLATION_r05.json`: `description`,
`config`, `points` (psnr, ssim, rmse, abs_rel, delta_1 and the seconds of
each point; points already in `out` are kept, not rerun) and
`qualitative_checks`, Table 6's orderings checked on the points. Any other
`key=value` goes to every point's config. Runs on CUDA unless `--device
cpu` is given.
"""

from __future__ import annotations

import json
import os
import sys
import time

from outdoor_nerf_depth_torch.tools.full_budget_run import REPO, ensure_fixture
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device, train

CONFIGS = {
    "mip": os.path.join(REPO, "configs", "kitti_mipnerf360.json"),
    "ngp": os.path.join(REPO, "configs", "kitti_ngp.json"),
    "nerfpp": os.path.join(REPO, "configs", "kitti_nerfpp.json"),
}
LOSSES = ("mse", "l1", "kl")
PRIORS = ("gt", "stereo_crop", "mono_crop")
KEEP = ("psnr", "ssim", "rmse", "abs_rel", "delta_1")


def grid():
    """(point name, its overrides): loss x prior, then rgbonly."""
    return [
        (f"depth_loss_type_{loss}-depth_sup_type_{prior}",
         (f"depth_loss_type={loss}", f"depth_sup_type={prior}"))
        for loss in LOSSES for prior in PRIORS
    ] + [("rgbonly", ("lambda_depth=0.0", "depth_sup_type=gt"))]


def run_point(config_path, scene, exp_root, name, steps, sample_every, extra, device):
    config = load_config(
        config_path,
        [
            f"scene_dir={scene}",
            f"exp_dir={os.path.join(exp_root, name)}",
            f"max_steps={steps}",
            f"sample_every={sample_every}",
            "print_every=500",
            "train_render_every=0",
            "checkpoint_every=1000000",
            "compute_ssim=true",
            *extra,
        ],
    )
    model, _ = train(config, device=device)
    mean, _ = evaluate(config, model, device=device, save_renders=False)
    return {k: round(float(mean[k]), 4) for k in KEEP if k in mean}


def qualitative_checks(points):
    """Table 6's orderings on the points: depth RMSE gt < stereo < mono <
    rgbonly under mse and l1, every loss beating rgbonly's AbsRel with the
    gt prior, and PSNR within 1.5 dB across the points."""
    def rmse(loss, prior):
        return points[f"depth_loss_type_{loss}-depth_sup_type_{prior}"]["rmse"]

    rgb = points["rgbonly"]
    checks = {}
    for loss in ("mse", "l1"):
        checks[f"{loss}_rmse_orders_gt<stereo<mono<rgbonly"] = bool(
            rmse(loss, "gt") < rmse(loss, "stereo_crop") < rmse(loss, "mono_crop") < rgb["rmse"]
        )
    checks["depth_sup_beats_rgbonly_on_abs_rel(all losses, gt prior)"] = all(
        points[f"depth_loss_type_{loss}-depth_sup_type_gt"]["abs_rel"] < rgb["abs_rel"]
        for loss in LOSSES
    )
    psnrs = [p["psnr"] for p in points.values()]
    checks["psnr_spread_small(<1.5dB)"] = bool(max(psnrs) - min(psnrs) < 1.5)
    return checks


def main(argv):
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    device = resolve_device(device)
    kv = dict(a.split("=", 1) for a in argv)
    out = kv.pop("out", os.path.join(REPO, "build", "sweep_ablation.json"))
    fixture = kv.pop("fixture", os.path.join(REPO, "build", "kitti_fixture"))
    exp_root = kv.pop("exp_root", os.path.join(REPO, "build", "fixture_ablation"))
    steps = int(kv.pop("steps", 2000))
    sample_every = int(kv.pop("sample_every", 4))
    backend = kv.pop("backend", "mip")
    if backend not in CONFIGS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {sorted(CONFIGS)}")
    extra = tuple(f"{k}={v}" for k, v in kv.items())
    ensure_fixture(fixture)
    scene = os.path.join(fixture, "nerfpp" if backend == "nerfpp" else "dtu_format")
    config_path = CONFIGS[backend]

    result = {
        "description": (
            f"Table-6-style ablation on the KITTI fixture ({backend}, {steps} steps, sparse "
            f"views sample_every={sample_every}): loss {{mse,l1,kl}} x prior "
            "{gt,stereo_crop,mono_crop} + rgbonly baseline (lambda_depth=0). Deliverable is "
            "the qualitative ORDERING (BASELINE.md Table 6), not absolute numbers."
        ),
        "config": config_path,
        "points": {},
    }
    if os.path.isfile(out):
        with open(out) as f:
            result["points"] = json.load(f).get("points", {})
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    for name, overrides in grid():
        if name in result["points"]:
            print(f"=== {name}: cached ===", flush=True)
            continue
        print(f"=== ablation point {name} ===", flush=True)
        t0 = time.perf_counter()
        result["points"][name] = run_point(config_path, scene, exp_root, name, steps,
                                           sample_every, extra + overrides, device)
        result["points"][name]["train_eval_seconds"] = round(time.perf_counter() - t0, 1)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
        print(json.dumps({name: result["points"][name]}), flush=True)

    result["qualitative_checks"] = qualitative_checks(result["points"])
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result["qualitative_checks"], indent=1), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
