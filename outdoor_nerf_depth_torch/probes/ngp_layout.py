"""NGP hash-encode layouts side by side at the KITTI training shape.

Port of `benchmarks/probes/ngp_layout_probe.py`. For each layout (osplit,
oct, quad, corner) it times, on the device it runs on:

- `bench_layout`: the encode forward (the gather bill) and forward +
  backward through the layout's sorted table gradient, on 8192 x 64 points
  at L 16, F 2, T 2^19 (resolutions 16 to 2048), with the K2a launches of
  the forward + backward;
- `bench_full_step`: the NGP bench step (`workloads.ngp_bench_config`:
  scale 0.5, max_samples 64, n_candidates 256, bfloat16, batch 8192) on the
  synthetic scene of 8 views of 94x310, after a warmup occupancy refresh of
  its 128^3 grid and three untimed steps (`--log2t` sizes its table too,
  `--grid-res` the grid).

Seconds are medians of `timeit` (see TIMING_METHOD); the step's rays/s is
the batch over its median.

    python -m outdoor_nerf_depth_torch.probes.ngp_layout [--device cpu]
        [--layouts oct,quad] [--samples N] [--log2t K] [--batch B] [--grid-res R]
        [--reps R] [--step-reps R] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from outdoor_nerf_depth_torch.ops import hashgrid
from outdoor_nerf_depth_torch.probes import TIMING_METHOD, timed_launches, timeit, workloads
from outdoor_nerf_depth_torch.train.loop import resolve_device

LAYOUTS = ("osplit", "oct", "quad", "corner")
SAMPLES = 8192 * 64  # rays x samples at the KITTI NGP shape
LEVELS, FEATURES = 16, 2
N_MIN, N_MAX = 16, 2048
BATCH = 8192

_PLAIN = {"osplit": hashgrid.encode_oct_split, "oct": hashgrid.encode_oct,
          "quad": hashgrid.encode_quad, "corner": hashgrid.encode}
_SORTED = {"osplit": hashgrid.OctSplitEncode, "oct": hashgrid.OctEncode,
           "quad": hashgrid.QuadEncode, "corner": hashgrid.CornerEncode}


def bench_layout(layout: str, device, samples: int = SAMPLES, log2_table_size: int = 19,
                 reps: int = 3, seed: int = 0) -> dict:
    """fwd_s and fwd_bwd_s of one layout's encode; its K2a launches."""
    table_size = 2**log2_table_size
    res = tuple(int(r) for r in hashgrid.level_resolutions(LEVELS, N_MIN, N_MAX))
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((samples, 3), generator=gen, device=device)
    table = torch.randn((LEVELS, table_size, FEATURES), generator=gen, device=device) * 1e-2
    with torch.no_grad():
        fwd_s = timeit(lambda: _PLAIN[layout](x, table, res, table_size).sum(), device, reps)[0]
    tg = table.clone().requires_grad_(True)

    def fwd_bwd():
        out = _SORTED[layout].apply(x, tg, res, table_size)
        return torch.autograd.grad(torch.sum(torch.sin(out)), tg)

    fwd_bwd_s, launches = timed_launches(fwd_bwd, device, reps, "K2a")
    return {"fwd_s": fwd_s, "fwd_bwd_s": fwd_bwd_s, "launches": {"K2a": launches}}


def bench_full_step(layout: str, device, batch: int = BATCH, reps: int = 10,
                    log2_table_size: int = 19, grid_resolution: int = 128,
                    seed: int = 0) -> dict:
    """step_s and rays_per_sec of the NGP bench step (`workloads.ngp_bench_config`)
    under `layout` (the field's default widths, its table at
    2^log2_table_size rows, the occupancy grid at grid_resolution^3 cells)."""
    config = workloads.ngp_bench_config(batch, hash_layout=layout,
                                        grid_resolution=grid_resolution,
                                        field_params={"log2_table_size": log2_table_size})
    trainer = workloads.bench_trainer(config, device, seed=seed)
    trainer.refresh(warmup=True)

    def one_step():
        return float(trainer.step()["loss"])

    for _ in range(2):
        one_step()
    step_s = timeit(one_step, device, reps)[0]
    return {"step_s": step_s, "rays_per_sec": batch / step_s}


def run(device=None, layouts=LAYOUTS, samples: int = SAMPLES, log2_table_size: int = 19,
        batch: int = BATCH, reps: int = 3, step_reps: int = 10, grid_resolution: int = 128,
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    results = {"backend": dev.type, "device": str(dev),
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "samples": samples, "levels": LEVELS, "log2_table_size": log2_table_size,
               "batch": batch, "grid_resolution": grid_resolution, "reps": reps,
               "step_reps": step_reps,
               "timing_method": TIMING_METHOD}
    for layout in layouts:
        results[layout] = bench_layout(layout, dev, samples, log2_table_size, reps, seed)
    for layout in layouts:
        results[layout]["full"] = bench_full_step(layout, dev, batch, step_reps, log2_table_size,
                                                  grid_resolution, seed)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.probes.ngp_layout")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--layouts", default=",".join(LAYOUTS))
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--log2t", type=int, default=19)
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--step-reps", type=int, default=10)
    parser.add_argument("--grid-res", type=int, default=128)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    layouts = tuple(args.layouts.split(","))
    unknown = set(layouts) - set(LAYOUTS)
    if unknown:
        parser.error(f"unknown layouts {sorted(unknown)}; expected some of {LAYOUTS}")
    results = run(args.device, layouts, args.samples, args.log2t, args.batch, args.reps,
                  args.step_reps, args.grid_res)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
