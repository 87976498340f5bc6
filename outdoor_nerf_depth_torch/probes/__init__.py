"""Probes: entry points that time the hash grid's building blocks and the
bench operating points (`workloads`).

- `osplit_bwd`: the osplit hash-table backward stage by stage, and its
  batched-across-levels variants (16 sorts against one, 16 scans against one
  launch of the batched scan K2b);
- `gather_attack`: ways to gather 16-lane rows, against table size, sort
  operand count, a table held in shared memory (P1) and a one-hot product on
  the tensor cores (P2);
- `ngp_layout`: the hash layouts' encodes and NGP steps side by side;
- `ngp_step`: the NGP bench step with its occupancy refreshes, in rays/s;
- `ngp_bwd`: the oct layout's table gradient stage by stage, and variants;
- `ngp_eval`: NGP's iterative eval renderer against the dense one;
- `nerfpp_mfu`: the NeRF++ bench step over batch and steps a dispatch, in
  rays/s and TFLOP/s;
- `nerfpp_ablate`: the NeRF++ bench step with one part cut at a time;
- `profile_step`: the NeRF++ bench step under torch.profiler.

Each runs on CUDA unless asked for the CPU (`run(device="cpu")`,
`--device cpu`), catches no kernel failure, and returns a dict of seconds
(or rates) from `timeit` or a named method, with the device it ran on, and
the kernel launches its calls made, read from the port's launch record
(`ops/cuda_build.py:launches`).
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import time

import torch

from outdoor_nerf_depth_torch.ops import cuda_build

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


def timed_launches(fn, device: torch.device, reps: int, kid: str):
    """timeit(...) plus {"calls", "launches"}: the launches of kernel `kid` over them."""
    before = cuda_build.launches()
    seconds, calls = timeit(fn, device, reps)
    return seconds, {"calls": calls, "launches": launches_since(before)[kid]}


def launches_since(before: dict) -> dict:
    """The launches of each kernel since `cuda_build.launches()` gave `before`."""
    return {k: n - before[k] for k, n in cuda_build.launches().items()}


@functools.cache
def _nvidia_smi() -> tuple:
    """nvidia-smi's name and power limit of each card, queried once a process."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return tuple(smi.strip().splitlines())


def card(device: torch.device) -> dict:
    """What the numbers were measured on: the card's name and, from
    nvidia-smi, its name and power limit ("cpu" and None on the CPU). A
    probe calls it once, before it times anything."""
    if device.type != "cuda":
        return {"kind": "cpu", "nvidia_smi": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"kind": torch.cuda.get_device_name(device), "nvidia_smi": _nvidia_smi()[index]}
