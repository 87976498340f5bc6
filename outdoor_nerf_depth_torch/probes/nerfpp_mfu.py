"""NeRF++ bench step across batch and steps a dispatch: rays/s and TFLOP/s.

Port of `benchmarks/probes/nerfpp_mfu_probe.py`. For each (batch, K) of the
sweep it trains the NeRF++ bench config (`workloads.nerfpp_bench_config`:
cascade 64 + 128, fg and bg 8x256 fields, bfloat16) on the synthetic scene
of 8 views of 94x310, K steps a dispatch on K fixed batches (as the loop's
`steps_per_dispatch` K runs them, one host sync a dispatch). After two
untimed dispatches it times `n_meas` dispatches, each on the host clock
ended by its sync, and reports the median's rays/s, steps/s and ms a step.
FLOPs are counted from the `nn.Linear` shapes of the fields (2 a
multiply-add, x3 for the backward); `mfu_pct` is the share of the H100's
published dense bf16 peak, 989 TFLOP/s (NVIDIA's data sheet, SXM, 700 W).

    python -m outdoor_nerf_depth_torch.probes.nerfpp_mfu [--device cpu]
        [--sweep 1024x8,4096x32] [--n-meas 6] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from outdoor_nerf_depth_torch.ops import cuda_build
from outdoor_nerf_depth_torch.probes import card, launches_since, sync, workloads
from outdoor_nerf_depth_torch.train.loop import resolve_device

SWEEP = ((1024, 8), (1024, 32), (1024, 128), (4096, 8), (4096, 32))
PEAK_BF16_TFLOPS = 989.0
WARM_DISPATCHES = 2


def linear_flops(module: torch.nn.Module, n: int) -> int:
    """Multiply-add FLOPs of every nn.Linear in `module` on n inputs."""
    return sum(2 * n * layer.in_features * layer.out_features
               for layer in module.modules() if isinstance(layer, torch.nn.Linear))


def forward_flops(model, n_rays: int) -> int:
    """FLOPs of the fg and bg fields of every level on that level's samples
    (level i runs on the first i + 1 cascade counts together)."""
    total, samples = 0, 0
    for level, n in enumerate(model.cascade_samples):
        samples += n
        fields = getattr(model, f"level{level}")
        total += linear_flops(fields.fg_field, n_rays * samples)
        total += linear_flops(fields.bg_field, n_rays * samples)
    return total


def dispatch_times(trainer, k: int, n_meas: int, warm: int = WARM_DISPATCHES):
    """Seconds of each of `n_meas` timed dispatches of k steps (after `warm`
    untimed ones), and the launches of the timed ones."""
    def dispatch():
        for _ in range(k):
            stats = trainer.step()
        float(stats["loss"])  # the host sync ending the dispatch

    for _ in range(warm):
        dispatch()
    before, times = cuda_build.launches(), []
    for _ in range(n_meas):
        sync(trainer.device)
        t0 = time.perf_counter()
        dispatch()
        times.append(time.perf_counter() - t0)
    return times, launches_since(before)


def measure(config, k: int, n_meas: int, device, seed: int = 0) -> dict:
    """The config's step, k a dispatch: the median dispatch's rates."""
    trainer = workloads.bench_trainer(config, device, n_batches=k, seed=seed)
    times, launches = dispatch_times(trainer, k, n_meas)
    dt = statistics.median(times)
    batch = config.batch_size
    step_tflop = 3 * forward_flops(trainer.model, batch) / 1e12
    tflops = step_tflop * k / dt
    return {"batch": batch, "k": k, "n_meas": n_meas, "dispatch_s": times,
            "rays_per_sec": batch * k / dt, "steps_per_sec": k / dt,
            "step_ms": 1e3 * dt / k, "step_tflop": step_tflop, "tflop_per_s": tflops,
            "mfu_pct": 100.0 * tflops / PEAK_BF16_TFLOPS, "launches": launches}


def run(device=None, sweep=SWEEP, n_meas: int = 6, seed: int = 0, **model_params) -> dict:
    """`model_params` change the bench model (the tests' small widths)."""
    dev = resolve_device(device)
    return {"device": str(dev), **card(dev), "peak_bf16_tflops": PEAK_BF16_TFLOPS,
            "timing_method": "host clock around each dispatch of k steps, ended by its sync; "
                             "median of n_meas after 2 untimed",
            "sweep": [measure(workloads.nerfpp_bench_config(batch, model_params), k, n_meas,
                              dev, seed) for batch, k in sweep]}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.probes.nerfpp_mfu")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--sweep", default=",".join(f"{b}x{k}" for b, k in SWEEP),
                        help="batch x steps a dispatch, comma-separated")
    parser.add_argument("--n-meas", type=int, default=6)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    sweep = tuple(tuple(int(v) for v in p.split("x")) for p in args.sweep.split(","))
    results = run(args.device, sweep, args.n_meas)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
