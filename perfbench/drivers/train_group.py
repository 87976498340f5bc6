"""Traffic driver of a data-parallel trainer: one `train` call on each of
`chips` ranks of a process group, the port's `parallel/` over NCCL.

The harness process is rank 0; it starts ranks 1.. as processes of this
module, with the environment torchrun would give them
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR=localhost`, a free
`MASTER_PORT`), and each joins the group with the port's
`parallel.init_from_env`, builds its dataset share and makes the one-card
driver's `train` call with its window (`drivers/train.py`): rank 0 decides
when the window closes, and one all-reduce a synchronized point carries
that decision and every rank's count of non-finite losses, so the call
ends on every rank at the same step. The rate counts the global batch.
Each rank writes what rank 0 needs (its followed batches, its peak memory,
its traced busy time) to a file of a directory under TMPDIR; rank 0 waits
for every rank's process to end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

from perfbench import scene as scene_lib
from perfbench import harness
from perfbench.drivers import common
from perfbench.drivers import train as train_driver

GROUP_TIMEOUT_S = 120.0


def rank_main(run, rank: int, scene_dir: str, exp_dir: str, out_dir: str):
    """One rank's `train` call in the group; returns (window, first steps,
    program config); writes its share of the result to `out_dir`."""
    import torch

    from outdoor_nerf_depth_torch import parallel

    on_card = run.device == "cuda"
    device = parallel.init_from_env(None if on_card else "cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        window, follow, config, scene_load_s = train_driver.train_call(run, rank, device,
                                                                       scene_dir, exp_dir)
        summary = window.tracer.summary() if window.tracer is not None else None
        share = {"batches": follow.batches, "peak": max(window.setup_peak, window.window_peak),
                 "busy_s": None if summary is None else summary.busy_s,
                 "scene_load_s": scene_load_s}
        torch.save(share, os.path.join(out_dir, f"rank{rank}.pt"))
        return window, follow, config, summary
    finally:
        parallel.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _group_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def run(run):
    import torch

    world = run.cell.chips
    params = common.scene_params(run)
    scene_dir = scene_lib.ensure_scene(run.cache_root, params)
    exp_dir = tempfile.mkdtemp(prefix="perfbench-exp-")
    out_dir = tempfile.mkdtemp(prefix="perfbench-group-")
    port = _free_port()
    spec = {"workload": run.cell.name, "seed": run.seed, "seconds": run.seconds,
            "trace": run.trace, "device": run.device, "root": run.root,
            "cache_root": run.cache_root, "program_overrides": run.program_overrides,
            "scene_overrides": run.scene_overrides, "traffic_overrides": run.traffic_overrides,
            "scene_dir": scene_dir, "exp_dir": exp_dir, "out_dir": out_dir}
    procs = [subprocess.Popen([sys.executable, "-m", "perfbench.drivers.train_group",
                               json.dumps(spec)],
                              env=dict(os.environ, **_group_env(r, world, port)),
                              cwd=harness.ROOT)
             for r in range(1, world)]
    os.environ.update(_group_env(0, world, port))
    try:
        window, follow, config, summary = rank_main(run, 0, scene_dir, exp_dir, out_dir)
    finally:
        for p in procs:
            try:
                p.wait(timeout=GROUP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for key in _group_env(0, world, port):
            os.environ.pop(key, None)
        shutil.rmtree(exp_dir, ignore_errors=True)
    try:
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"a rank failed: exit codes {[p.returncode for p in procs]}")
        shares = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                  for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # The reference follows the global batch: the ranks' rows in rank order.
    follow.batches = [{k: None if shares[0]["batches"][i][k] is None else
                       torch.cat([s["batches"][i][k] for s in shares])
                       for k in shares[0]["batches"][i]} for i in range(len(follow.batches))]
    if summary is not None:
        busy = [s["busy_s"] for s in shares]
        summary = dataclasses.replace(summary, busy_s=sum(busy) / len(busy))
    return common.train_measured(
        run, window, follow, config, params, scene_dir, scene_load_s=shares[0]["scene_load_s"],
        memory_peak=max(s["peak"] for s in shares), trace=summary)


def _rank_process(spec: dict):
    harness.prepare_process(spec["root"])
    cell = harness.load_cell(spec["workload"], spec["root"])
    run = harness.Run(cell, spec["seed"], spec["seconds"], spec["trace"], spec["device"],
                      time.perf_counter(), cache_root=spec["cache_root"], root=spec["root"],
                      program_overrides=spec["program_overrides"],
                      scene_overrides=spec["scene_overrides"],
                      traffic_overrides=spec["traffic_overrides"])
    rank_main(run, int(os.environ["RANK"]), spec["scene_dir"], spec["exp_dir"], spec["out_dir"])


if __name__ == "__main__":
    _rank_process(json.loads(sys.argv[1]))
