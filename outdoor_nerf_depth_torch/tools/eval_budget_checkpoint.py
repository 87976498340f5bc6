"""Evaluate a full-budget run's latest checkpoint as a partial quality entry.

    python -m outdoor_nerf_depth_torch.tools.eval_budget_checkpoint backend=ngp \\
        [out=build/quality_full.json] [fixture=build/kitti_fixture] \\
        [exp_root=build/full_budget] [note="..."] [--device cpu] [key=value ...]

The port's counterpart of the repository's `tools/eval_budget_checkpoint.py`.
A run of `tools/full_budget_run.py` that stopped before its budget still
holds trained state in its checkpoints: this restores the latest one for
one backend (`exp_root/<backend>`, with the run's config and the tool's
`key=value` overrides), evaluates the test split with the same `evaluate`
the run ends with, and writes an entry with `"partial": true`, the
checkpoint's step and the backend's full budget (`budget_steps`) into the
runs of `out`, replacing that backend's entry and keeping the others. A
backend without a checkpoint is an error. Runs on CUDA unless `--device
cpu` is given; `device` names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import sys

from outdoor_nerf_depth_torch.tools.full_budget_run import REPO, RUNS, check_backend, device_label
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device


def main(argv):
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    device = resolve_device(device)
    kv = dict(a.split("=", 1) for a in argv)
    backend = kv.pop("backend")
    check_backend(backend)
    out = kv.pop("out", os.path.join(REPO, "build", "quality_full.json"))
    fixture = kv.pop("fixture", os.path.join(REPO, "build", "kitti_fixture"))
    exp_root = kv.pop("exp_root", os.path.join(REPO, "build", "full_budget"))
    note = kv.pop("note", "")
    extra = tuple(f"{k}={v}" for k, v in kv.items())

    spec = RUNS[backend]
    config = load_config(
        spec["config"],
        [
            f"scene_dir={os.path.join(fixture, spec['scene_sub'])}",
            f"exp_dir={os.path.join(exp_root, backend)}",
            "compute_ssim=true",
            *extra,
        ],
    )
    if not ckpt_lib.latest_step(os.path.join(config.exp_dir, "checkpoints")):
        raise SystemExit(f"no checkpoint under {config.exp_dir}")
    model, step = step_lib.load_checkpoint(config)
    mean, _ = evaluate(config, model, device=device, save_renders=False)
    entry = {
        "backend": backend,
        "steps": int(step),
        "batch": config.batch_size,
        "partial": True,
        "budget_steps": spec["steps"],
        "note": note,
        "metrics": {k: round(float(v), 4) for k, v in mean.items()},
    }
    results = {"device": device_label(device), "runs": []}
    if os.path.isfile(out):
        with open(out) as f:
            results = json.load(f)
    results["runs"] = [r for r in results.get("runs", []) if r["backend"] != backend] + [entry]
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(entry))


if __name__ == "__main__":
    main(sys.argv[1:])
