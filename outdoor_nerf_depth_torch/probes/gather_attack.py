"""Ways to gather the hash grid's 16-lane rows, timed at its size.

Port of `benchmarks/probes/gather_attack_probe.py`. At 8192 x 64 x 16 =
8,388,608 queries of 16 lanes it measures:

  A. `index_select` ns per row from bf16 [2^k, 16] tables, k in 13, 16, 19,
     22: does a small table gather faster?
  B. sort cost against operand count (1, 2, 5, 10 operands of 8.4M): torch
     has no multi-operand sort, so this is one key sort plus one
     permutation gather per payload operand.
  C. P1, `ops/chunk_gather.take_from_chunk`: rows from an f32 [2048, 16]
     table held in shared memory, beside `index_select` on the same inputs.
  D. P2, `ops/chunk_gather.onehot_extract`: rows of a bf16 table of
     2^19 x 12 rows extracted as one-hot products on the tensor cores, one
     512-row chunk per tile of 256 queries, beside `index_select` of the
     same rows (row ids computed beforehand) and a cast to f32.

    python -m outdoor_nerf_depth_torch.probes.gather_attack [--device cpu]
        [--queries N] [--onehot-rows R] [--reps R] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from outdoor_nerf_depth_torch.ops import chunk_gather
from outdoor_nerf_depth_torch.probes import TIMING_METHOD, timed_launches, timeit
from outdoor_nerf_depth_torch.train.loop import resolve_device

QUERIES = 8192 * 64 * 16
LANES = chunk_gather.LANES
TABLE_LOG2_ROWS = (13, 16, 19, 22)
SORT_OPERANDS = (1, 2, 5, 10)
ONEHOT_ROWS = 2**19 * 12  # about the trimmed oct table


def run(device=None, queries: int = QUERIES, reps: int = 3,
        table_log2_rows=TABLE_LOG2_ROWS, onehot_rows: int = ONEHOT_ROWS, seed: int = 0) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = queries
    results = {"device": str(dev), "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu", "n_queries": q, "lanes": LANES, "reps": reps,
               "timing_method": TIMING_METHOD}
    launches = {}

    def t(fn):
        return timeit(fn, dev, reps)[0]

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=gen, device=dev, dtype=torch.int32)

    # A. Gather cost against table size.
    for log2_rows in table_log2_rows:
        table = torch.randn((2**log2_rows, LANES), generator=gen, device=dev).to(torch.bfloat16)
        idx = randint(2**log2_rows, q)
        results[f"A_take_2^{log2_rows}rows_ns_per_row"] = \
            t(lambda: torch.index_select(table, 0, idx)) / q * 1e9
    del table, idx

    # B. Sort cost against operand count.
    keys = randint(2**22, q)
    payload = [torch.arange(q, device=dev, dtype=torch.int32)] + [
        torch.randn((q,), generator=gen, device=dev) for _ in range(max(SORT_OPERANDS) - 2)]

    def sort_with(n_ops):
        sorted_keys, perm = torch.sort(keys)
        return [sorted_keys] + [p[perm] for p in payload[:n_ops - 1]]

    for n_ops in SORT_OPERANDS:
        results[f"B_sort_{n_ops}ops_s"] = t(lambda: sort_with(n_ops))
    results["B_method"] = ("torch has no multi-operand sort: one key sort (values and indices) "
                           "plus one permutation gather per payload operand")
    del keys, payload

    # C. P1: rows from a table held in shared memory.
    table = torch.randn((chunk_gather.TAKE_CHUNK, LANES), generator=gen, device=dev)
    idx = randint(chunk_gather.TAKE_CHUNK, q)
    seconds, launches["P1"] = timed_launches(
        lambda: chunk_gather.take_from_chunk(idx, table), dev, reps, "P1")
    results["C_smem_take_ns_per_row"] = seconds / q * 1e9
    results["C_library_ns_per_row"] = t(lambda: torch.index_select(table, 0, idx)) / q * 1e9
    results["C_max_abs_err"] = float((chunk_gather.take_from_chunk(idx, table)
                                      - torch.index_select(table, 0, idx)).abs().max())
    del table, idx

    # D. P2: one-hot row extraction on the tensor cores.
    chunk, tile = chunk_gather.ONEHOT_CHUNK, chunk_gather.ONEHOT_TILE
    table = torch.randn((onehot_rows, LANES), generator=gen, device=dev).to(torch.bfloat16)
    idx = randint(chunk, q)
    seconds, launches["P2"] = timed_launches(
        lambda: chunk_gather.onehot_extract(idx, table, chunk, tile), dev, reps, "P2")
    results["D_onehot_ns_per_row"] = seconds / q * 1e9
    results["D_onehot_total_s"] = seconds
    rows = chunk_gather.onehot_rows(q, onehot_rows, chunk, tile, dev) + idx
    results["D_library_ns_per_row"] = \
        t(lambda: torch.index_select(table, 0, rows).to(torch.float32)) / q * 1e9
    results["D_max_abs_err"] = float((chunk_gather.onehot_extract(idx, table, chunk, tile)
                                      - torch.index_select(table, 0, rows).float()).abs().max())
    results["D_shape"] = {"table_rows": onehot_rows, "chunk": chunk, "tile": tile,
                          "tiles": -(-q // tile), "chunks": onehot_rows // chunk}
    results["launches"] = launches
    results["library"] = {"C": "torch.index_select(table, 0, idx)",
                          "D": "torch.index_select(table, 0, rows).float(), row ids precomputed"}
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m outdoor_nerf_depth_torch.probes.gather_attack")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--queries", type=int, default=QUERIES)
    parser.add_argument("--onehot-rows", type=int, default=ONEHOT_ROWS)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    results = run(args.device, args.queries, args.reps, onehot_rows=args.onehot_rows)
    print(json.dumps(results, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
