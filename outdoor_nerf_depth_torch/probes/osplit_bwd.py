"""Per-stage timing of the osplit hash-table backward, and batched variants.

Port of `benchmarks/probes/ngp_osplit_bwd_probe.py`. At the bench KITTI
shape (8192 rays x 64 samples = 524,288 points, L 16, F 2, T 2^19,
resolutions 16 to 2048) it times:

- the osplit encode forward and forward + backward through `OctSplitEncode`
  (one K3a, one K2b and one K3b launch per backward);
- the table gradient alone, in one pass over all levels as the backward
  runs it (`table_grad_one_pass_s`, one K2b launch a call) against the
  per-level pipeline it replaced (`table_grad_per_level_s`: a sort, K2a and
  a roll fold a level, 16 K2a launches a call), and the one pass's stages:
  the one int32 sort of the level-offset keys (beside the same sort on
  int64 keys), K3a and K3b beside their plain versions, the segment ends;
  the two pipelines must agree (`one_pass_matches`);
- per-level stages at the last (hashed) level: the data sort, the value
  gather (bf16, as the backward gathers), the prefix scan as `torch.cumsum`
  and as K2a, the reference's two sentinel sorts and the port's
  `searchsorted` in their place, and the row sums by the port's pipeline and
  by the reference's "merged" one, which must agree (`merged_matches`);
- batched-across-levels variants: 16 stable sorts against one [16, m] sort,
  16 scans against one launch of K2b at [16, m, 16], 16 value gathers
  against one batched gather.

`osplit_fwd_bwd_plain_scan_derived_s` stands for the reference probe's
`osplit_fwd_bwd_xla_cumsum_s`, which flips a switch the port does not have:
it is derived, fwd+bwd + 16 x (plain scan - kernel scan) at one level.

    python -m outdoor_nerf_depth_torch.probes.osplit_bwd [--device cpu]
        [--samples N] [--log2t K] [--reps R] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from outdoor_nerf_depth_torch.ops import hashgrid, hashgrid_grad, prefix_scan
from outdoor_nerf_depth_torch.probes import TIMING_METHOD, timed_launches, timeit
from outdoor_nerf_depth_torch.train.loop import resolve_device

LEVELS, FEATURES = 16, 2
LANES = 8 * FEATURES
SAMPLES = 8192 * 64


def _sentinel_bounds(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """b_r = #(idx <= r) by the reference's two sentinel sorts."""
    rows = torch.arange(n_rows, device=idx.device, dtype=idx.dtype)
    sorted_keys = torch.sort(torch.cat([idx * 2, rows * 2 + 1])).values
    _, order = torch.sort((sorted_keys & 1) ^ 1, stable=True)
    return order[:n_rows] - rows


def run(device=None, samples: int = SAMPLES, log2_table_size: int = 19, reps: int = 3,
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    res = tuple(int(r) for r in hashgrid.level_resolutions(LEVELS, 16, 2048))
    table_size = 2**log2_table_size
    level_rows = hashgrid._oct_level_rows(res, table_size)
    m = samples
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((m, 3), generator=gen, device=dev)
    g = torch.randn((m, LEVELS * FEATURES), generator=gen, device=dev)
    table = torch.randn((LEVELS, table_size, FEATURES), generator=gen, device=dev) * 1e-2
    results = {"device": str(dev), "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu", "m": m, "levels": LEVELS, "log2_table_size": log2_table_size,
               "level_rows": level_rows, "reps": reps, "timing_method": TIMING_METHOD}
    launches = {}

    def t(fn):
        return timeit(fn, dev, reps)[0]

    # ---- The full osplit encode, forward and forward + backward.
    with torch.no_grad():
        results["osplit_fwd_s"] = t(lambda: hashgrid.OctSplitEncode.apply(x, table, res,
                                                                          table_size))
    xg, tg = x.clone().requires_grad_(True), table.clone().requires_grad_(True)

    def fwd_bwd():
        out = hashgrid.OctSplitEncode.apply(xg, tg, res, table_size)
        return torch.autograd.grad((out * g).sum(), (xg, tg))

    results["osplit_fwd_bwd_s"], launches["osplit_fwd_bwd"] = timed_launches(
        fwd_bwd, dev, reps, "K2b")

    # ---- The table gradient alone: one pass against the per-level pipeline.
    with torch.no_grad():
        idx_levels, w_all = hashgrid._oct_local_indices_weights(x, res, table_size)
        level_keys = hashgrid._level_keys(idx_levels, table_size)
    g_lf = g.reshape(m, LEVELS, FEATURES)

    def per_level():
        return hashgrid._oct_split_table_grad_per_level(idx_levels, w_all, g_lf, res, table_size)

    def one_pass():
        return hashgrid._oct_split_table_grad(level_keys, w_all, g_lf, res, table_size)

    results["table_grad_one_pass_s"], launches["table_grad_one_pass"] = timed_launches(
        one_pass, dev, reps, "K2b")
    results["table_grad_per_level_s"], launches["table_grad_per_level"] = timed_launches(
        per_level, dev, reps, "K2a")
    got, want = one_pass(), per_level()
    results["one_pass_max_abs_diff"] = float((got - want).abs().max())
    results["table_grad_max_abs"] = float(want.abs().max())
    # Two f32 orders of the same bf16 products' prefix sums (1e-4 of the
    # largest entry, as the card tests hold them).
    results["one_pass_matches"] = results["one_pass_max_abs_diff"] <= 1e-4 * max(
        results["table_grad_max_abs"], 1e-30)
    keys64 = torch.stack([i.reshape(-1) for i in idx_levels]) + torch.arange(
        0, LEVELS * table_size, table_size, device=dev)[:, None]
    results["sort_level_keys_int64_s"] = t(lambda: torch.sort(keys64.reshape(-1)))
    results["sort_level_keys_int32_s"] = t(lambda: hashgrid._sorted_level_keys(level_keys))
    sorted_keys, order = hashgrid._sorted_level_keys(level_keys)
    results["products_kernel_s"], launches["products_kernel"] = timed_launches(
        lambda: hashgrid_grad.sorted_products(order, w_all, g_lf), dev, reps, "K3a")
    results["products_plain_s"] = t(
        lambda: hashgrid_grad.sorted_products_plain(order, w_all, g_lf))
    csum = prefix_scan.cumsum_batched(hashgrid_grad.sorted_products_plain(order, w_all, g_lf))
    results["segment_ends_s"] = t(
        lambda: hashgrid._level_segment_ends(sorted_keys, LEVELS, table_size))
    ends = hashgrid._level_segment_ends(sorted_keys, LEVELS, table_size)
    offsets = [hashgrid._oct_offsets(r, table_size) for r in res]
    fold_args = (csum, ends, offsets, level_rows, table_size)
    results["fold_kernel_s"], launches["fold_kernel"] = timed_launches(
        lambda: hashgrid_grad.fold_segments(*fold_args), dev, reps, "K3b")
    results["fold_plain_s"] = t(lambda: hashgrid_grad.fold_segments_plain(*fold_args))
    del got, want, csum, ends, keys64

    # ---- Per-level stages at the last level (hashed: rows == T).
    level = LEVELS - 1
    idx = idx_levels[level].reshape(-1)
    n_rows = level_rows[level]
    vals = torch.randn((m, LANES), generator=gen, device=dev)
    vals_bf16 = vals.to(torch.bfloat16)
    results["index_dtype"] = str(idx.dtype)

    results["sort_data_1lvl_s"] = t(lambda: torch.sort(idx))
    sorted_idx, sd = torch.sort(idx)
    results["vgather_1lvl_s"] = t(lambda: vals_bf16[sd])
    sv = vals_bf16[sd].to(torch.float32)
    results["cumsum_plain_1lvl_s"] = t(lambda: prefix_scan.cumsum_plain(sv))
    results["cumsum_kernel_1lvl_s"], launches["cumsum_kernel_1lvl"] = timed_launches(
        lambda: prefix_scan.cumsum(sv), dev, reps, "K2a")
    results["sentinel_sorts_1lvl_s"] = t(lambda: _sentinel_bounds(idx, n_rows))
    rows = torch.arange(n_rows, device=dev, dtype=idx.dtype)
    results["searchsorted_1lvl_s"] = t(lambda: torch.searchsorted(sorted_idx, rows, right=True))
    results["row_sums_1lvl_s"] = t(lambda: hashgrid._oct_split_row_sums(idx, vals, n_rows))
    results["row_sums_merged_1lvl_s"] = t(
        lambda: hashgrid._oct_split_row_sums_merged(idx, vals, n_rows))
    diff = float((hashgrid._oct_split_row_sums(idx, vals, n_rows)
                  - hashgrid._oct_split_row_sums_merged(idx, vals, n_rows)).abs().max())
    results["merged_max_abs_diff"] = diff
    # The reference probe's criterion: the two orders of f32 sums agree to 5e-2.
    results["merged_matches"] = diff < 5e-2
    results["osplit_fwd_bwd_plain_scan_derived_s"] = results["osplit_fwd_bwd_s"] + LEVELS * (
        results["cumsum_plain_1lvl_s"] - results["cumsum_kernel_1lvl_s"])

    # ---- Batched across levels.
    idx_all = torch.stack([il.reshape(-1) for il in idx_levels])  # [L, m]
    vals_all = torch.randn((LEVELS, m, LANES), generator=gen, device=dev)
    results["sort_16_separate_s"] = t(lambda: torch.stack(
        [torch.sort(idx_all[lv], stable=True).indices for lv in range(LEVELS)]))
    results["sort_batched_s"] = t(lambda: torch.sort(idx_all, dim=1, stable=True).indices)
    results["cumsum_plain_16_s"] = t(lambda: torch.stack(
        [prefix_scan.cumsum_plain(vals_all[lv]) for lv in range(LEVELS)]))
    results["cumsum_kernel_16_separate_s"], launches["cumsum_kernel_16_separate"] = \
        timed_launches(lambda: [prefix_scan.cumsum(vals_all[lv]) for lv in range(LEVELS)],
                       dev, reps, "K2a")
    results["cumsum_kernel_batched_s"], launches["cumsum_kernel_batched"] = timed_launches(
        lambda: prefix_scan.cumsum_batched(vals_all), dev, reps, "K2b")
    sd_all = torch.sort(idx_all, dim=1, stable=True).indices
    vals_all_bf16 = vals_all.to(torch.bfloat16)
    results["vgather_16_separate_s"] = t(lambda: torch.stack(
        [vals_all_bf16[lv][sd_all[lv]] for lv in range(LEVELS)]))
    results["vgather_batched_s"] = t(lambda: torch.gather(
        vals_all_bf16, 1, sd_all[..., None].expand(-1, -1, LANES)))

    results["launches"] = launches
    results["notes"] = {
        "osplit_fwd_bwd_plain_scan_derived_s": "derived, not measured: osplit_fwd_bwd_s + 16 x "
                                               "(cumsum_plain_1lvl_s - cumsum_kernel_1lvl_s)",
        "cumsum": "plain = torch.cumsum in f32; kernel = K2a per level, K2b batched "
                  "(on the CPU both are the plain version)",
        "table_grad": "one pass = the backward's table gradient (one sort, K3a, one K2b, "
                      "searchsorted, K3b); per level = a sort, bf16 products, K2a and a roll "
                      "fold a level (on the CPU both take the plain versions)",
        "sorts": "torch.sort; its indices stand for the reference's iota sort operand",
        "value_gathers": "from bf16 values, as the backward gathers them",
    }
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.probes.osplit_bwd")
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
