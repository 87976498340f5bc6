"""Read the output check's numbers of many seeds in one process, with the control.

    python3 -m perfbench.readings --workload mip360_kitti.train \\
        --seeds 1,2,3 [--control] [--seconds 2] --out chiprun_out/readings.jsonl

Each seed is a run of the cell as the benchmark makes it, through the same
set-up and output check, with a short window (a train cell's window opens
at its first synchronized point past the followed steps, which no window
changes). With `--control` the check also reads the control: the
reference computed one precision below the configuration's (TF32 for
float32 with TF32 off) in the program's place, against the reference.
A train cell's check, and a view cell's check of its set-up's training,
also reads a fault planted in the reference put in the program's place:
half of each batch left out, the mean taken over the rest. One line per seed: every number.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from perfbench import harness


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    harness.prepare_process()
    cell = harness.load_cell(args.workload)
    traffic = {}
    if cell.traffic["driver"] == "train":
        every = cell.traffic["print_every"]
        traffic["warmup_steps"] = -(-cell.traffic["follow_steps"] // every) * every
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.Run(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                          traffic_overrides=traffic, control=args.control)
        result = harness.execute(run)
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "wall_s": time.perf_counter() - run.t_start,
                "checks": {k: v["value"] for k, v in result["checks"].items()}}
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
