"""NGP's eval renderers side by side: the iterative one against the dense
train path, across chunk sizes.

Port of `benchmarks/probes/ngp_eval_probe.py`. For each chunk size it
builds the NGP bench model (`workloads.ngp_bench_config`, batch = chunk)
as a converged opaque surface: the density output's bias raised by 5 and
an occupancy grid that is 1 only on the shell 0.25 < |c| < 0.32 of the
innermost cascade's cells (the geometry a trained outdoor grid shows, so
that empty-space skipping and early termination both engage). It renders
view 0 of the bench scene, its rays tiled to fill the chunk, through
`render_image` with `ngp_eval_renderer` "iterative" (`render_eval`) and
"train" (the dense path, one K1a launch a chunk), and reports rays/s of
each (the chunk over the median of `reps` renders after one untimed) and
their ratio, with the K1a launches of each timed group.

    python -m outdoor_nerf_depth_torch.probes.ngp_eval [--device cpu]
        [--chunks 8192,16384,32768] [--reps 10] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.ops import occupancy as occ_lib
from outdoor_nerf_depth_torch.probes import TIMING_METHOD, card, timed_launches, workloads
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.loop import resolve_device

CHUNKS = (8192, 16384, 32768)
MODES = ("iterative", "train")
SIGMA_BIAS = 5.0
SHELL = (0.25, 0.32)


def shell_grid(scale: float, resolution: int) -> torch.Tensor:
    """[cascades, R^3]: 1 on the cells of cascade 0 whose centre (as the
    reference orders the cells, x slowest) lies on the shell, else 0."""
    cells = np.arange(resolution**3)
    coords = np.stack([cells // (resolution * resolution), (cells // resolution) % resolution,
                       cells % resolution], -1).astype(np.float32)
    radius = np.linalg.norm((coords + 0.5) / resolution - 0.5, axis=-1)
    grid = occ_lib.init_grid(scale, resolution)
    grid[0] = torch.from_numpy(((radius > SHELL[0]) & (radius < SHELL[1])).astype(np.float32))
    return grid


def tiled_view(dataset, chunk: int) -> rays_lib.Batch:
    """View 0's rays repeated to `chunk` rays, as a [1, chunk] image."""
    rays = dataset.image_batch(0).rays
    h, w = rays.origins.shape[:2]
    reps = -(-chunk // (h * w))
    return rays_lib.Batch(rays=rays_lib.map_fields(
        lambda r: r.reshape((h * w,) + r.shape[2:]).repeat(
            (reps,) + (1,) * (r.ndim - 2))[:chunk][None], rays))


@torch.no_grad()
def make_shell(model):
    """Turn an NGP model into the opaque shell: its density bias raised by
    SIGMA_BIAS, its grid the shell grid."""
    model.field.sigma_out.bias[0] += SIGMA_BIAS
    model.occupancy.copy_(shell_grid(model.scale, model.grid_resolution))
    return model


def shell_scene(chunk: int, device, max_samples: int = 64, seed: int = 0, **model_params):
    """(config, the bench model initialized from `seed` as the shell on
    `device`, the [1, chunk] batch of view 0's tiled rays)."""
    config = workloads.ngp_bench_config(chunk, max_samples, **model_params)
    model = step_lib.build_model(config, generator=torch.Generator().manual_seed(seed))
    dataset, _ = workloads.bench_scene(chunk, device, n_batches=0)
    return config, make_shell(model).to(device), tiled_view(dataset, chunk)


def run(device=None, chunks=CHUNKS, reps: int = 10, max_samples: int = 64, seed: int = 0,
        **model_params) -> dict:
    dev = resolve_device(device)
    results = {"device": str(dev), **card(dev), "reps": reps, "timing_method": TIMING_METHOD,
               "launches_counted": "K1a"}
    for chunk in chunks:
        _, model, batch = shell_scene(chunk, dev, max_samples, seed, **model_params)
        entry, launches = {}, {}
        for mode in MODES:
            seconds, launches[mode] = timed_launches(
                lambda: step_lib.render_image(model, batch, chunk, dev, mode), dev, reps, "K1a")
            entry[f"{mode}_s"] = seconds
            entry[mode] = chunk / seconds
        entry["speedup_iter_vs_dense"] = entry["iterative"] / entry["train"]
        entry["launches"] = launches
        results[f"chunk_{chunk}"] = entry
        del model
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.probes.ngp_eval")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--chunks", default=",".join(str(c) for c in CHUNKS))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    results = run(args.device, tuple(int(c) for c in args.chunks.split(",")), args.reps)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
