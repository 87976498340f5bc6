"""The oct layout's hash-table gradient stage by stage, at the KITTI shape.

Port of `benchmarks/probes/ngp_bwd_probe.py`. On `samples` points (8192 rays
x 64 samples) at L 16, F 2, T 2^19 it times, on the device it runs on, the
forward's stages (`build_oct_table`, the row gather, the trilerp, indices
and weights) and each stage of `OctEncode.backward`:

- vals: the corner weights times the cotangent, [m, 8F] (m = points x L);
- sort1: the stable sort of the m row ids;
- vgather: the values gathered in that order;
- scan: their f32 prefix sum as the port runs it (K2a on the GPU), beside
  `torch.cumsum` along the rows and along a transposed [8F, m] layout;
- segment_ends: where each row's segment ends (`searchsorted`), the port's
  stand-in for the reference's sentinel sort, which is timed beside it
  (sentinel_sort: the stable partition of the m + rows interleaved keys);
- fgather: the prefix sums at the segment ends, differenced;
- fold: the rolls of each level's physical rows back onto the table;
- dx: the analytic trilinear gradient of the points;
- the row sums by `index_add_` on unsorted and on sorted row ids;

then three variants of the row sums (a bf16 value carry, w and g gathered
apart and multiplied after the gather, the scan along the transposed
layout) and the whole backward through autograd. Each backward stage runs
on the previous one's output, so the fold's output is the table gradient
that the timed stages compose to; the run reports its largest difference
from the backward's (`composed_vs_backward_max_abs`, beside the backward's
largest entry). K2a launches are counted for each timed group.

    python -m outdoor_nerf_depth_torch.probes.ngp_bwd [--device cpu]
        [--samples N] [--log2t K] [--reps R] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from outdoor_nerf_depth_torch.ops import hashgrid, prefix_scan
from outdoor_nerf_depth_torch.probes import TIMING_METHOD, card, timed_launches
from outdoor_nerf_depth_torch.train.loop import resolve_device

SAMPLES = 8192 * 64
LEVELS, FEATURES = 16, 2
N_MIN, N_MAX = 16, 2048


def run(device=None, samples: int = SAMPLES, log2_table_size: int = 19, reps: int = 3,
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    table_size = 2**log2_table_size
    res = tuple(int(r) for r in hashgrid.level_resolutions(LEVELS, N_MIN, N_MAX))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((samples, 3), generator=gen, device=dev)
    g = torch.randn((samples, LEVELS, FEATURES), generator=gen, device=dev)
    table = torch.randn((LEVELS, table_size, FEATURES), generator=gen, device=dev) * 1e-2
    idx, w_all = hashgrid._oct_indices_weights(x, res, table_size)
    idx_flat = idx.reshape(-1)
    m = idx_flat.shape[0]
    n_rows = sum(hashgrid._oct_level_rows(res, table_size))
    results = {"device": str(dev), **card(dev), "samples": samples, "m": m, "n_rows": n_rows,
               "levels": LEVELS, "log2_table_size": log2_table_size, "reps": reps,
               "timing_method": TIMING_METHOD, "launches": {}}

    def stage(name, fn):
        with torch.no_grad():
            seconds, counted = timed_launches(fn, dev, reps, "K2a")
        results[f"{name}_s"] = seconds
        results["launches"][name] = counted
        return fn()

    # The forward's stages.
    phys = stage("build_oct", lambda: hashgrid.build_oct_table(table, res, table_size))
    rows = stage("rowgather", lambda: phys[idx])
    stage("trilerp", lambda: hashgrid._blend_levels(rows.reshape(rows.shape[:-1] + (8, FEATURES)),
                                                    w_all))
    stage("idxw", lambda: hashgrid._oct_indices_weights(x, res, table_size))

    # The backward's stages, each on the previous one's output.
    vals = stage("vals", lambda: hashgrid._oct_vals(w_all, g))
    sorted_idx, order = stage("sort1", lambda: torch.sort(idx_flat, stable=True))
    v = stage("vgather", lambda: vals[order])
    csum = stage("scan", lambda: prefix_scan.cumsum(v))
    stage("cumsum", lambda: torch.cumsum(v, dim=0))
    v_t = v.t().contiguous()
    stage("cumsum_T", lambda: torch.cumsum(v_t, dim=1))
    keys = torch.cat([idx_flat * 2, torch.arange(n_rows, device=dev, dtype=idx_flat.dtype) * 2 + 1])
    sentinel_keys = torch.sort(keys, stable=True)[0]
    stage("sentinel_sort", lambda: torch.sort((sentinel_keys & 1) ^ 1, stable=True))
    ends = stage("segment_ends", lambda: hashgrid._segment_ends(sorted_idx, n_rows))
    seg = stage("fgather", lambda: hashgrid._sums_at_ends(csum, ends))
    composed = stage("fold", lambda: hashgrid._fold_oct_levels(seg, res, table_size, FEATURES))
    s8 = hashgrid._corner_sums(g, rows.reshape(rows.shape[:-1] + (8, FEATURES)))
    stage("dx", lambda: hashgrid._trilinear_dx(x, res, s8))
    stage("scatter_unsorted",
          lambda: vals.new_zeros((n_rows, vals.shape[1])).index_add_(0, idx_flat, vals))
    stage("scatter_sorted",
          lambda: v.new_zeros((n_rows, v.shape[1])).index_add_(0, sorted_idx, v))

    # Variants of the row sums.
    def bwd_bf16():
        vb = (w_all.to(torch.bfloat16)[..., None] * g.to(torch.bfloat16)[..., None, :])
        vb = vb.reshape(-1, 8 * FEATURES)
        si, o = torch.sort(idx_flat, stable=True)
        cs = prefix_scan.cumsum(vb[o].to(torch.float32))
        return hashgrid._sums_at_ends(cs, hashgrid._segment_ends(si, n_rows))

    def bwd_factored():
        si, o = torch.sort(idx_flat, stable=True)
        wv, gv = w_all.reshape(-1, 8)[o], g.reshape(-1, FEATURES)[o]
        vv = (wv[..., None] * gv[..., None, :]).reshape(-1, 8 * FEATURES)
        return hashgrid._sums_at_ends(prefix_scan.cumsum(vv), hashgrid._segment_ends(si, n_rows))

    def bwd_transposed():
        si, o = torch.sort(idx_flat, stable=True)
        cs = torch.cumsum(vals[o].t().contiguous(), dim=1).t()
        return hashgrid._sums_at_ends(cs, hashgrid._segment_ends(si, n_rows))

    stage("bwd_bf16", bwd_bf16)
    stage("bwd_factored", bwd_factored)
    stage("bwd_transposed", bwd_transposed)

    # The whole backward of the encode, through autograd.
    tg = table.clone().requires_grad_(True)
    cotangent = g.reshape(samples, LEVELS * FEATURES)

    def full():
        out = hashgrid.OctEncode.apply(x, tg, res, table_size)
        return torch.autograd.grad(out, tg, cotangent)[0]

    seconds, counted = timed_launches(full, dev, reps, "K2a")
    results["full_bwd_s"], results["launches"]["full_bwd"] = seconds, counted
    want = full()
    results["composed_vs_backward_max_abs"] = float(torch.max(torch.abs(composed - want)))
    results["backward_max_abs"] = float(torch.max(torch.abs(want)))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.probes.ngp_bwd")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--log2t", type=int, default=19)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    results = run(args.device, args.samples, args.log2t, args.reps)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
