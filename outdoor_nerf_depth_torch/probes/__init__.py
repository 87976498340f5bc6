"""Kernel probes: entry points that time the hash grid's building blocks.

- `osplit_bwd`: the osplit hash-table backward stage by stage, and its
  batched-across-levels variants (16 sorts against one, 16 scans against one
  launch of the batched scan K2b);
- `gather_attack`: ways to gather 16-lane rows, against table size, sort
  operand count, a table held in shared memory (P1) and a one-hot product on
  the tensor cores (P2).

Each runs on CUDA unless asked for the CPU (`run(device="cpu")`,
`--device cpu`), catches no kernel failure, and returns a dict of seconds
or ns per row from `timeit`, whose method the results name.
"""

from __future__ import annotations

import statistics
import time

import torch

TIMING_METHOD = ("host clock around one call, the device synchronized before and after it; "
                 "median of `reps` calls after one untimed call")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device: torch.device, reps: int):
    """(median seconds of one call of `fn`, calls made), as TIMING_METHOD says."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), reps + 1


def timed_launches(fn, device: torch.device, reps: int, count):
    """timeit(...) plus {"calls", "launches"}: what `count()` rose by over them."""
    before = count()
    seconds, calls = timeit(fn, device, reps)
    return seconds, {"calls": calls, "launches": count() - before}
