"""Evaluate a trained scene's checkpoint, or compare renders on disk offline.

    python -m outdoor_nerf_depth_torch.tools.eval [--config exp/config.json] \\
        [--device cpu] [key=value ...]
    python -m outdoor_nerf_depth_torch.tools.eval --offline <gt_image_dir> \\
        <pred_dir> [out.txt] [--lpips] [--device cpu]

The port's counterpart of the repository's `eval.py`. The first form
restores the latest checkpoint of the config's `exp_dir` (or its
`slim_checkpoint`), prints `restored step N` and evaluates the test split,
saving the renders into `exp_dir/renders/`. The second recomputes the test
split of the scene's image folder and scores the predictions in
`pred_dir` (`train/offline_eval.py`). Runs on CUDA unless `--device cpu`
is given (offline, only LPIPS computes on the device).
"""

from __future__ import annotations

import sys

from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, resolve_device
from outdoor_nerf_depth_torch.train.offline_eval import evaluate_renders


def split_flags(argv):
    """(`--device` value or None, `--config` value or None, the rest)."""
    device = path = None
    rest = []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it)
        elif arg == "--config":
            path = next(it)
        else:
            rest.append(arg)
    return device, path, rest


def main(argv):
    device, path, rest = split_flags(argv)
    device = resolve_device(device)
    if rest and rest[0] == "--offline":
        args = [a for a in rest[1:] if a != "--lpips"]
        out = args[2] if len(args) > 2 else None
        return evaluate_renders(args[0], args[1], out_path=out, compute_lpips="--lpips" in rest,
                                device=device)
    config = load_config(path, rest)
    model, step = step_lib.load_checkpoint(config)
    print(f"restored step {step}")
    return evaluate(config, model, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
