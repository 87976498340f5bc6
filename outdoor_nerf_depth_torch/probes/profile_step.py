"""The NeRF++ bench step under torch.profiler: the ops with the most device time.

Port of `benchmarks/probes/profile_step.py`. It trains the NeRF++ bench
config (`workloads.nerfpp_bench_config`, batch 1024, 8 steps a dispatch)
on the synthetic scene: 2 untimed dispatches, 4 timed ones (rays/s and ms
a step, host clock ended by a sync), then 2 dispatches under
`torch.profiler` with CPU and CUDA activities. It reports the `top` ops by
self device time over those 2 dispatches, each with its ms and share of
the total, and writes the profiler's Chrome trace into `trace_dir`. On the
CPU the ops are ranked by self CPU time instead.

    python -m outdoor_nerf_depth_torch.probes.profile_step [--device cpu]
        [--trace-dir build/nerfpp_trace] [--top 25] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from outdoor_nerf_depth_torch.probes import card, workloads
from outdoor_nerf_depth_torch.probes.nerfpp_mfu import dispatch_times
from outdoor_nerf_depth_torch.train.loop import resolve_device

BATCH, K = 1024, 8
STEADY, PROFILED = 4, 2


def run(device=None, trace_dir: str = "build/nerfpp_trace", top: int = 25, batch: int = BATCH,
        k: int = K, seed: int = 0, **model_params) -> dict:
    dev = resolve_device(device)
    measured_on = card(dev)
    config = workloads.nerfpp_bench_config(batch, model_params)
    trainer = workloads.bench_trainer(config, dev, n_batches=k, seed=seed)
    times, launches = dispatch_times(trainer, k, STEADY)
    steady = sum(times)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        dispatch_times(trainer, k, PROFILED, warm=0)
    os.makedirs(trace_dir, exist_ok=True)
    trace = os.path.join(trace_dir, "nerfpp_step_trace.json")
    prof.export_chrome_trace(trace)
    clock = "self_device_time_total" if dev.type == "cuda" else "self_cpu_time_total"
    ops = [e for e in prof.key_averages() if getattr(e, clock) > 0 and (
        dev.type != "cuda" or e.device_type == torch.autograd.DeviceType.CPU)]
    total_us = sum(getattr(e, clock) for e in ops)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no time")
    ranked = sorted(ops, key=lambda e: getattr(e, clock), reverse=True)[:top]
    return {"device": str(dev), **measured_on, "batch": batch, "k": k,
            "steady_dispatches": STEADY, "rays_per_sec": batch * k * STEADY / steady,
            "step_ms": 1e3 * steady / (k * STEADY), "median_dispatch_s": statistics.median(times),
            "launches": launches, "profiled_dispatches": PROFILED,
            "ranked_by": clock, "total_ms": total_us / 1e3, "trace": trace,
            "top_ops": [{"op": e.key, "ms": getattr(e, clock) / 1e3,
                         "share": getattr(e, clock) / total_us, "calls": e.count}
                        for e in ranked]}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m outdoor_nerf_depth_torch.probes.profile_step")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--trace-dir", default="build/nerfpp_trace")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    results = run(args.device, args.trace_dir, args.top)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
