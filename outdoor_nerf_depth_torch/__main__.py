"""CLI: train a scene, then evaluate it.

    python -m outdoor_nerf_depth_torch --config configs/kitti_mipnerf360.json \
        dataset=synthetic max_steps=5 [--device cpu] [--no-eval]

    torchrun --nproc_per_node=N -m outdoor_nerf_depth_torch \
        --config configs/kitti_mipnerf360.json [key=value ...]

Runs on CUDA unless `--device` names another device. Under torchrun's
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`) each process joins the process group first: NCCL on
`cuda:LOCAL_RANK`, gloo with `--device cpu`. A failed init raises (no
fallback to gloo or to the CPU), and the group it joined is left at exit.
Without that environment no process group is made.
"""

from __future__ import annotations

import argparse
import sys

from outdoor_nerf_depth_torch import parallel
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
    device, joined = args.device, False
    if parallel.mesh.in_torchrun_env() and not parallel.active():
        device, joined = parallel.init_from_env(device), True
    try:
        model, _ = train(config, device=device)
        if not args.no_eval:
            evaluate(config, model, device=device)
    finally:
        if joined:
            parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
