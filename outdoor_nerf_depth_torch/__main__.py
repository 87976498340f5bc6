"""CLI: train a scene, then evaluate it.

    python -m outdoor_nerf_depth_torch --config configs/kitti_mipnerf360.json \
        dataset=synthetic max_steps=5 [--device cpu] [--no-eval]

Runs on CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import sys

from outdoor_nerf_depth_torch.train.config import load_config
from outdoor_nerf_depth_torch.train.loop import evaluate, train


def main(argv):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch")
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--no-eval", action="store_true", help="skip the test-split eval")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)
    config = load_config(args.config, args.overrides)
    model, _ = train(config, device=args.device)
    if not args.no_eval:
        evaluate(config, model, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
