"""NGP train-step throughput at the KITTI training shape, refreshes included.

Port of `benchmarks/ngp_step.py`: the NGP bench step
(`workloads.ngp_bench_config`: hash grid L16 F2 T2^19, `max_samples` slots
from 4x as many candidates, bfloat16) at `batch` rays on the synthetic
scene of 8 views of 94x310. After a warmup occupancy refresh and three
untimed steps it times `steps` steps in one window on the host clock,
ended by a device sync, with a sampled refresh before every 16th step (0
and 16 of 20), as the reference trains. One card: the rate is not divided
by a chip count.

    python -m outdoor_nerf_depth_torch.probes.ngp_step [--device cpu]
        [--batch 8192] [--max-samples 64] [--steps 20] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from outdoor_nerf_depth_torch.ops import cuda_build
from outdoor_nerf_depth_torch.probes import card, launches_since, sync, workloads
from outdoor_nerf_depth_torch.train.loop import resolve_device

REFRESH_EVERY = 16
WARM_STEPS = 3


def run(device=None, batch: int = 8192, max_samples: int = 64, steps: int = 20,
        seed: int = 0, **model_params) -> dict:
    """{"metric": "ngp_rays_per_sec", "value", "unit", "batch", "max_samples",
    "steps", "seconds", "launches" of the timed window, and the card}."""
    dev = resolve_device(device)
    measured_on = card(dev)
    config = workloads.ngp_bench_config(batch, max_samples, **model_params)
    trainer = workloads.bench_trainer(config, dev, seed=seed)
    trainer.refresh(warmup=True)
    for _ in range(WARM_STEPS):
        stats = trainer.step()
    float(stats["loss"])
    before = cuda_build.launches()
    sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        if i % REFRESH_EVERY == 0:
            trainer.refresh(warmup=False)
        stats = trainer.step()
    float(stats["loss"])  # waits for the device
    seconds = time.perf_counter() - t0
    return {"metric": "ngp_rays_per_sec", "value": batch * steps / seconds, "unit": "rays/s",
            "batch": batch, "max_samples": max_samples, "steps": steps,
            "refreshes": len(range(0, steps, REFRESH_EVERY)), "seconds": seconds,
            "launches": launches_since(before), **measured_on}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.probes.ngp_step")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--max-samples", type=int, default=64)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    result = run(args.device, args.batch, args.max_samples, args.steps)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
