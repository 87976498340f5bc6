"""Train and evaluate Instant-NGP on each scene of a public benchmark suite.

    python -m outdoor_nerf_depth_torch.tools.run_public_benchmark synthetic_nerf \\
        root=/data/Synthetic_NeRF [scenes=Lego,Chair] [out=bench_synthetic_nerf.json] \\
        [steps=20000] [--device cpu] [key=value config overrides...]

The port's counterpart of `benchmarks/run_public_benchmark.py`: one registry
of the public suites (dataset reader, scenes, NGP world scale and any
per-suite change), one config for every scene (NGP in bfloat16, batch
16384, 4096 for the mip-NeRF 360 scenes, 8 steps a dispatch, lr 2e-2 to
2e-3, no depth supervision, distortion and opacity 1e-3), and a summary
JSON with each scene's test metrics and their mean over the keys every
scene has. Each scene trains into `exp/public_bench/<scene>` unless
`exp_dir=` says otherwise. The scenes are not in the repository: point
`root` at the suite's standard layout. Runs on CUDA unless `--device cpu`
is given.
"""

from __future__ import annotations

import json
import os
import sys

from outdoor_nerf_depth_torch.tools.eval import split_flags
from outdoor_nerf_depth_torch.train.config import Config, _parse_value
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device, train

# Each suite's scenes, reader, NGP world scale and deviations from the
# shared config.
SUITES = {
    "synthetic_nerf": dict(
        dataset="blender", scale=0.5,
        scenes=["Chair", "Drums", "Ficus", "Hotdog", "Lego", "Materials",
                "Mic", "Ship"],
    ),
    "synthetic_nsvf": dict(
        dataset="nsvf", scale=0.5,
        scenes=["Wineholder", "Steamtrain", "Toad", "Robot", "Bike",
                "Palace", "Spaceship", "Lifestyle"],
    ),
    "blendedmvs": dict(
        dataset="nsvf", scale=0.5,
        scenes=["Jade", "Fountain", "Character", "Statues"],
    ),
    "tat": dict(  # Tanks and Temples (training subset, NSVF layout)
        dataset="nsvf", scale=0.5, factor=2,
        scenes=["Ignatius", "Truck", "Barn", "Caterpillar", "Family"],
    ),
    "nerfpp": dict(  # tat_intermediate_*/tat_training_* NeRF++ layout
        dataset="nerfpp", scale=4.0,
        scenes=["tat_intermediate_M60", "tat_intermediate_Playground",
                "tat_intermediate_Train", "tat_training_Truck"],
    ),
    "mipnerf360": dict(
        dataset="driving", scale=16.0, batch=4096, factor=4,
        scenes=["bicycle", "bonsai", "counter", "garden", "kitchen",
                "room", "stump"],
    ),
    "rtmv": dict(
        dataset="rtmv", scale=0.5,
        scenes=["4_Privet_Drive", "V8"],
    ),
}


def scene_config(suite: dict, root: str, scene: str, steps: int, overrides=()) -> Config:
    """The config one scene of `suite` trains under, then `overrides` (key=value)."""
    config = Config(
        model="ngp",
        model_params=dict(scale=suite["scale"], max_samples=64,
                          n_candidates=256, compute_dtype="bfloat16"),
        compute_dtype="bfloat16",
        dataset=suite["dataset"],
        scene_dir=os.path.join(root, scene),
        factor=suite.get("factor", 0),
        batch_size=suite.get("batch", 16384),
        max_steps=steps,
        steps_per_dispatch=8,
        lr_init=2e-2,
        lr_final=2e-3,
        lr_delay_steps=0,
        grad_max_norm=0.0,
        lambda_depth=0.0,
        depth_sup_type="rgbonly",
        interlevel_loss_mult=0.0,
        distortion_loss_mult=1e-3,
        opacity_loss_mult=1e-3,
        print_every=1000,
        checkpoint_every=steps,
        exp_dir=os.path.join("exp/public_bench", scene),
    )
    for item in overrides:
        key, raw = item.split("=", 1)
        config = config.replace(**{key.lstrip("-"): _parse_value(raw)})
    return config


def run_scene(suite: dict, root: str, scene: str, steps: int, overrides=(), device=None) -> dict:
    """Train one scene and evaluate its test split; its mean metrics, rounded."""
    config = scene_config(suite, root, scene, steps, overrides)
    model, _ = train(config, device=device)
    mean, _ = evaluate(config, model, device=device)
    return {k: round(float(v), 4) for k, v in mean.items() if v is not None}


def main(argv):
    """Run the suite; returns the summary it writes to `out`."""
    device, _, argv = split_flags(argv)
    if not argv or argv[0] not in SUITES:
        raise SystemExit(f"usage: run_public_benchmark <{'|'.join(SUITES)}>"
                         " root=<dataset_root> [scenes=a,b] [steps=N] [--device cpu] [k=v...]")
    device = resolve_device(device)
    name = argv[0]
    kv = dict(a.split("=", 1) for a in argv[1:] if "=" in a)
    suite = SUITES[name]
    root = kv.pop("root")
    scenes = kv.pop("scenes", ",".join(suite["scenes"])).split(",")
    steps = int(kv.pop("steps", 20_000))
    out = kv.pop("out", f"bench_{name}.json")
    overrides = [f"{k}={v}" for k, v in kv.items()]

    results = {}
    for scene in scenes:
        print(f"=== {name}/{scene} ===", flush=True)
        results[scene] = run_scene(suite, root, scene, steps, overrides, device)
        print(json.dumps({scene: results[scene]}), flush=True)
    keys = set.intersection(*(set(r) for r in results.values()))
    summary = {
        "suite": name,
        "scenes": results,
        "mean": {k: round(sum(r[k] for r in results.values()) / len(results), 4)
                 for k in sorted(keys)},
    }
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary["mean"]))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
