"""Sweep runner: loss-type x depth-prior x view-sparsity grids.

    python -m outdoor_nerf_depth_torch.tools.sweep --config configs/spheres_ablation.json \\
        --grid depth_loss_type=mse,l1,kl --grid depth_sup_type=gt,stereo_like \\
        --grid sample_every=1,4 [--dry-run] [--device cpu] [base overrides ...]

The port's counterpart of the repository's `sweep.py`: each point of the
grid's product trains into `exp_dir/<name>` (name `key_value-key_value`,
or `single` without a grid) and is evaluated on the test split; the eval
means of all points go to `exp_dir/sweep_summary.json` after each point.
`--dry-run` prints the points and trains nothing. Runs on CUDA unless
`--device cpu` is given.
"""

from __future__ import annotations

import itertools
import json
import os
import sys

from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device, train


def parse_args(argv):
    """(config path, [(key, values)], base overrides, dry run, device)."""
    path, grids, overrides, dry, device = None, [], [], False, None
    it = iter(argv)
    for a in it:
        if a == "--config":
            path = next(it)
        elif a == "--grid":
            key, vals = next(it).split("=", 1)
            grids.append((key, vals.split(",")))
        elif a == "--dry-run":
            dry = True
        elif a == "--device":
            device = next(it)
        else:
            overrides.append(a)
    return path, grids, overrides, dry, device


def main(argv):
    path, grids, base_overrides, dry, device = parse_args(argv)
    device = resolve_device(device)
    keys = [k for k, _ in grids]
    results = {}
    base = load_config(path, base_overrides)

    for combo in itertools.product(*(v for _, v in grids)):
        name = "-".join(f"{k}_{v}" for k, v in zip(keys, combo)) or "single"
        overrides = base_overrides + [f"{k}={v}" for k, v in zip(keys, combo)]
        config = load_config(path, overrides)
        config = config.replace(exp_dir=os.path.join(base.exp_dir, name))
        print(f"=== sweep point {name} -> {config.exp_dir}")
        if dry:
            continue
        model, _ = train(config, device=device)
        mean, _ = evaluate(config, model, device=device)
        results[name] = mean
        with open(os.path.join(base.exp_dir, "sweep_summary.json"), "w") as f:
            json.dump(results, f, indent=2)

    if not dry:
        print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
