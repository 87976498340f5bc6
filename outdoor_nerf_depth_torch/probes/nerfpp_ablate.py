"""NeRF++ bench step with one part cut at a time: where its time goes.

Port of `benchmarks/probes/nerfpp_ablate_probe.py`. Each ablation changes
the NeRF++ bench config (`workloads.nerfpp_bench_config`) in one place and
times its step at batch 1024, 8 steps a dispatch, as `nerfpp_mfu.measure`
does:

  base      the bench shape
  width128  net_width 256 -> 128
  depth4    net_depth 8 -> 4
  pe4       pos_degrees 10 -> 4
  coarse0   cascade (64,) only
  samples32 cascade (32, 64)
  nodepth   lambda_depth 0

    python -m outdoor_nerf_depth_torch.probes.nerfpp_ablate [--device cpu]
        [--tags base,pe4] [--n-meas 6] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

from outdoor_nerf_depth_torch.probes import card, workloads
from outdoor_nerf_depth_torch.probes.nerfpp_mfu import measure
from outdoor_nerf_depth_torch.train.loop import resolve_device

ABLATIONS = (
    ("base", {}, {}),
    ("width128", {"net_width": 128}, {}),
    ("depth4", {"net_depth": 4}, {}),
    ("pe4", {"pos_degrees": 4}, {}),
    ("coarse0", {"cascade_samples": (64,)}, {}),
    ("samples32", {"cascade_samples": (32, 64)}, {}),
    ("nodepth", {}, {"lambda_depth": 0.0}),
)
BATCH, K = 1024, 8


def run(device=None, tags=None, n_meas: int = 6, batch: int = BATCH, k: int = K, seed: int = 0,
        **model_params) -> dict:
    """`model_params` apply under every ablation (the tests' small widths)."""
    dev = resolve_device(device)
    measured_on = card(dev)
    results = []
    for tag, model_overrides, config_overrides in ABLATIONS:
        if tags and tag not in tags:
            continue
        config = workloads.nerfpp_bench_config(batch, dict(model_params, **model_overrides),
                                               config_overrides)
        r = measure(config, k, n_meas, dev, seed)
        results.append({"tag": tag, **{key: r[key] for key in (
            "step_ms", "rays_per_sec", "dispatch_s", "launches")}})
    return {"device": str(dev), **measured_on, "batch": batch, "k": k, "n_meas": n_meas,
            "ablations": results}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m outdoor_nerf_depth_torch.probes.nerfpp_ablate")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--tags", default=None, help="comma-separated ablations (default: all)")
    parser.add_argument("--n-meas", type=int, default=6)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    known = [tag for tag, _, _ in ABLATIONS]
    tags = args.tags.split(",") if args.tags else None
    if tags and set(tags) - set(known):
        parser.error(f"unknown ablations {sorted(set(tags) - set(known))}; expected some of {known}")
    results = run(args.device, tags, args.n_meas)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
