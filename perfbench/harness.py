"""One run of one benchmark cell: load, warm up, measure, check, print one line.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from `BENCHMARK.json`: the
configuration's file (`configs[].file`), the traffic mix
(`perfbench/traffic/<traffic>.json`, whose `driver` names a module of
`perfbench/drivers/`) and each per-layer metric's reader
(`perfbench/metrics/<metric name>.py`, or the reader of the quantity the
name measures, the part before its first dot). A metric name with a dotted
suffix is its quantity split by the end-to-end metric it moves or the
cells that report it: a driver reports `train_rays_per_s`, and a cell
listed under `train_rays_per_s.host_paced` reports it under that name. The driver builds the program's
objects, runs the warm-up and the measured window, and hands back what it
measured and what the output check needs; this module reads the metrics,
runs the check against the plain reference once the program's state is
freed, and prints the result as the last line of standard output, with the
numbers compared last on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ROOT = os.path.join(ROOT, "build", "perfbench")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "outdoor_nerf_depth_tpu")


class NoResult(Exception):
    """The run cannot give a result (no card, a missing file): exit non-zero, print none."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # BENCHMARK.json entries that apply to this cell
    per_layer: list


@dataclasses.dataclass
class Measured:
    """What a driver hands back.

    `end_to_end` {metric: value}; `counters` anything the per-layer readers
    read (steps, views, rays, log lines); `trace` the reduced profiler trace
    (`perfbench.trace.Summary`) or None; `check` a zero-argument callable
    that runs the reference comparison once the program's state is gone
    and returns {name: (value, limit)}; `attempted` and `failed` the
    window's steps or views and those that failed.
    """

    end_to_end: Dict[str, float]
    counters: Dict[str, Any]
    attempted: int
    failed: int
    check: Callable[[], Dict[str, tuple]]
    memory_peak_bytes: int
    trace: Optional[Any] = None


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench_path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(bench_path):
        raise NoResult(f"no BENCHMARK.json at {root}")
    bench = _load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "perfbench", "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload) and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer)


def base_name(name: str) -> str:
    """The quantity a metric's name measures: the part before its first dot.
    `mfu_pct.host_paced` is `mfu_pct` split by the end-to-end metric it moves."""
    return name.split(".")[0]


def load_metric(name: str, root: str = ROOT):
    """The reader module of a per-layer metric: `perfbench/metrics/<name>.py`,
    or else the reader of its quantity, `perfbench/metrics/<base name>.py`."""
    folder = os.path.join(root, "perfbench", "metrics")
    path = os.path.join(folder, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(folder, base_name(name) + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def prepare_process(root: str = ROOT):
    """Fixed build and kernel-cache directories inside the checkout, and no
    library that loads JAX by itself: `torch.utils.tensorboard` pulls in
    TensorFlow, which imports JAX, where both are installed, so the port's
    metric writer is left to its JSON file."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton_cache"))
    os.environ["USE_FLAX"] = "0"
    sys.modules.setdefault("torch.utils.tensorboard", None)


def forbidden_loaded():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Run:
    """The run's arguments and surroundings, as drivers see them."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # process start on the host clock (perf_counter)
    cache_root: str = CACHE_ROOT
    root: str = ROOT  # the checkout whose BENCHMARK.json and data files the run reads
    program_overrides: Optional[dict] = None  # tests: smaller widths on the CPU
    scene_overrides: Optional[dict] = None
    traffic_overrides: Optional[dict] = None
    control: bool = False  # also read the control and the planted faults (perfbench.readings)


def read_per_layer(cell: Cell, run: Run, measured: Measured) -> dict:
    out = {}
    for entry in cell.per_layer:
        value = load_metric(entry["name"], run.root).read(run, measured)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def device_record(run: Run, measured: Measured) -> dict:
    import torch

    if run.device == "cuda":
        kind, count = torch.cuda.get_device_name(0), run.cell.chips
        platform = "gpu"
    else:
        kind, count, platform = "cpu", 1, "cpu"
    record = {"platform": platform, "kind": kind, "count": count,
              "memory_peak_bytes": int(measured.memory_peak_bytes)}
    if run.trace and measured.trace is not None:
        record["busy_s"] = measured.trace.busy_s
        record["window_s"] = measured.trace.window_s
    return record


def execute(run: Run) -> dict:
    """Drive the cell, check its output, and return the result object
    (the contract's keys, with `checks` last)."""
    cell = run.cell
    driver = load_driver(cell.traffic["driver"])
    measured = driver.run(run)
    gc.collect()
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    checks = measured.check()
    correct = measured.failed == 0 and all(
        value <= limit for name, (value, limit) in checks.items()
        if not name.startswith(("control.", "fault.")))
    if run.trace:
        metrics = read_per_layer(cell, run, measured)
    else:
        metrics = {m["name"]: {"value": measured.end_to_end[base_name(m["name"])],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": int(measured.attempted),
              "failed": int(measured.failed), "metrics": metrics,
              "device": device_record(run, measured)}
    if run.trace and measured.trace is not None:
        result["breakdown"] = measured.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m perfbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    prepare_process()
    try:
        cell = load_cell(args.workload)
        import torch  # after the cache directories are set

        if not torch.cuda.is_available():
            raise NoResult("CUDA is not available: the benchmark runs on an NVIDIA card only")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"{args.workload} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} visible")
        run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
        result = execute(run)
    except NoResult as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"perfbench: no result: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
