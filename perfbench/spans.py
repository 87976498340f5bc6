"""Where the host was while the card worked or idled: the traced window reduced
by the port's spans (`outdoor_nerf_depth_torch/utils/tracing.py`).

    python3 -m perfbench.spans --workload <cell> --seed <n> [--seconds 35] \\
        [--out spans.jsonl]

One traced run of the cell, as `python3 -m perfbench ... --trace 1` makes
it, whose profiler events are also reduced by the program's spans (user
annotations whose names start with one of `PREFIXES`):

- each span's count and inclusive host seconds in the window;
- the device seconds of the kernels, copies and sets each span launched: a
  device event's correlation id leads to its runtime call, and the
  innermost program span open on the calling thread at the call gets it
  (inclusive: every span around it too);
- the idle seconds of every gap between the window's device intervals, by
  the innermost program span open on the loop's thread (the one holding
  the window mark) at the gap's middle, or `OUTSIDE`;
- synchronizing runtime calls (`SYNC_CALLS`) by the innermost program span
  open at the call, or `OUTSIDE`, and by name. The derived count a step
  leaves out those whose innermost span is `loop.step` itself: the program
  makes none there, and a train driver's wrapper of the step, which
  synchronizes at its window's points, runs there.

A call on a thread with no program span open (autograd's backward thread,
whose caller waits in `step.backward`) goes to the loop thread's span at
that time. The line printed is the run's result with a `spans` key added:
these reductions and the quantities derived from them over the window's
steps or views. It reads the events the benchmark's own `Tracer` records
and changes nothing it measures.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

from perfbench import harness, stats, trace

PREFIXES = ("loop.", "data.", "step.", "ngp.", "mip.", "render.", "view.")
COMPUTE = ("step.", "ngp.", "mip.")  # a span of the train step or the models
OUTSIDE = "outside any span"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
              "cuMemcpy")
RUNTIME = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    start: int  # ns
    end: int
    tid: object
    correlation: object = None


def events_of(raw) -> list:
    """The complete ("X") events of a Chrome trace, in ns."""
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = int(round(e["ts"] * 1e3))
        out.append(Event(e["name"], e.get("cat", ""), start,
                         int(round((e["ts"] + e["dur"]) * 1e3)), e.get("tid"),
                         (e.get("args") or {}).get("correlation")))
    return out


def is_program_span(e: Event) -> bool:
    return e.cat == "user_annotation" and e.name.startswith(PREFIXES)


def open_spans_at(spans, times):
    """For each time (any order), the names of the spans open there, outermost
    first: `spans` are properly nested (start, end, name) of one thread."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, k = [()] * len(times), [], 0
    for i in order:
        t = times[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


@dataclasses.dataclass
class SpanSummary:
    window_s: float
    idle_s: float  # the window less the union of its device intervals
    host: dict  # span -> [count, inclusive host s]
    device_s: dict  # span -> inclusive device s; OUTSIDE for launches in no span
    device_s_self: dict  # innermost span -> device s
    idle_by_span: dict  # innermost span at the gap's middle (or OUTSIDE) -> s
    idle_outside_compute_s: float
    syncs_by_span: dict  # innermost span (or OUTSIDE) -> count
    syncs_by_name: dict  # runtime call -> count

    def program_syncs(self) -> int:
        """Synchronizing calls the program made: in a span, not `loop.step` itself."""
        return sum(n for k, n in self.syncs_by_span.items() if k not in (OUTSIDE, "loop.step"))

    def report(self, per: int, unit: str) -> dict:
        """The reductions, top spans, and the quantities derived over `per` steps or views."""
        n = max(per, 1)
        top = sorted(self.host, key=lambda k: -self.host[k][1])[:10]
        top_dev = sorted(self.device_s, key=lambda k: -self.device_s[k])[:10]
        derived = {
            "idle_outside_compute_pct": 100.0 * self.idle_outside_compute_s / self.window_s,
            "device_idle_pct": 100.0 * self.idle_s / self.window_s,
            f"host_syncs_per_{unit}": self.program_syncs() / n,
            "refresh_ms_per_step": 1e3 * self.device_s.get("loop.refresh", 0.0) / n,
            f"host_ms_per_{unit}": {k: 1e3 * self.host[k][1] / n for k in top},
            f"device_ms_per_{unit}": {k: 1e3 * self.device_s[k] / n for k in top_dev},
        }
        return {"window_s": self.window_s, "idle_s": self.idle_s,
                "idle_by_span": dict(sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])),
                "idle_outside_compute_s": self.idle_outside_compute_s,
                "syncs_by_span": dict(sorted(self.syncs_by_span.items(), key=lambda kv: -kv[1])),
                "syncs_by_name": self.syncs_by_name,
                "host": {k: self.host[k] for k in sorted(self.host)},
                "device_s": dict(sorted(self.device_s.items(), key=lambda kv: -kv[1])),
                "device_s_self": dict(sorted(self.device_s_self.items(), key=lambda kv: -kv[1])),
                "per": per, "derived": derived}


def summarize_spans(events) -> SpanSummary:
    """Reduce the events of a Chrome trace (`Event`s) by the program's spans,
    over the window that `trace.MARK` marks."""
    marks = [e for e in events if e.name == trace.MARK and e.cat == "user_annotation"]
    if not marks:
        raise ValueError("the trace holds no window mark")
    w0, w1, loop_tid = marks[0].start, marks[0].end, marks[0].tid
    spans_by_tid = defaultdict(list)
    host = defaultdict(lambda: [0, 0.0])
    for e in events:
        if is_program_span(e):
            spans_by_tid[e.tid].append((e.start, e.end, e.name))
            if w0 <= e.start < w1:
                host[e.name][0] += 1
                host[e.name][1] += (min(e.end, w1) - e.start) * 1e-9
    device = [e for e in events if e.cat in trace.DEVICE_WORK and e.end > w0 and e.start < w1]
    calls = {e.correlation: e for e in events
             if e.cat in RUNTIME and e.correlation is not None}

    def stacks(tid_times):
        """Open span names at each (tid, time): the thread's own, else the loop thread's."""
        out = [None] * len(tid_times)
        by_tid = defaultdict(list)
        for i, (tid, t) in enumerate(tid_times):
            by_tid[tid].append(i)
        for tid, idx in by_tid.items():
            found = open_spans_at(spans_by_tid.get(tid, []), [tid_times[i][1] for i in idx])
            for i, names in zip(idx, found):
                out[i] = names
        missing = [i for i, names in enumerate(out) if not names and tid_times[i][0] != loop_tid]
        found = open_spans_at(spans_by_tid.get(loop_tid, []), [tid_times[i][1] for i in missing])
        for i, names in zip(missing, found):
            out[i] = names
        return out

    # Device time by the span that launched it.
    launched = [(e, calls.get(e.correlation)) for e in device]
    found = iter(stacks([(c.tid, c.start) for _, c in launched if c is not None]))
    opened = [next(found) if c is not None else () for _, c in launched]  # no call: outside
    device_s, device_self = defaultdict(float), defaultdict(float)
    for (e, _), names in zip(launched, opened):
        dt = (min(e.end, w1) - max(e.start, w0)) * 1e-9
        device_self[names[-1] if names else OUTSIDE] += dt
        for name in set(names) or (OUTSIDE,):
            device_s[name] += dt
    # Idle gaps by the loop thread's span at their middle.
    holes = stats.gaps([(max(e.start, w0), min(e.end, w1)) for e in device], w0, w1)
    mids = open_spans_at(spans_by_tid.get(loop_tid, []), [0.5 * (a + b) for a, b in holes])
    idle, outside_compute = defaultdict(float), 0.0
    for (a, b), names in zip(holes, mids):
        idle[names[-1] if names else OUTSIDE] += (b - a) * 1e-9
        if not any(n.startswith(COMPUTE) for n in names):
            outside_compute += (b - a) * 1e-9
    # Synchronizing runtime calls by span.
    syncs = [e for e in events if e.cat in RUNTIME and e.name in SYNC_CALLS
             and w0 <= e.start < w1]
    syncs_by, syncs_by_name = defaultdict(int), defaultdict(int)
    for e, names in zip(syncs, stacks([(e.tid, e.start) for e in syncs])):
        syncs_by[names[-1] if names else OUTSIDE] += 1
        syncs_by_name[e.name] += 1
    return SpanSummary(window_s=(w1 - w0) * 1e-9, idle_s=sum(idle.values()),
                       host={k: list(v) for k, v in host.items()}, device_s=dict(device_s),
                       device_s_self=dict(device_self), idle_by_span=dict(idle),
                       idle_outside_compute_s=outside_compute, syncs_by_span=dict(syncs_by),
                       syncs_by_name=dict(syncs_by_name))


class SpanTracer(trace.Tracer):
    """The benchmark's `Tracer`, whose summary also reduces the same events
    by the program's spans (`self.spans`); the Summary itself is unchanged."""

    spans = None

    def summary(self) -> trace.Summary:
        fd, path = tempfile.mkstemp(prefix="perfbench-spans-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        events = events_of(raw)
        self.spans = summarize_spans(events)
        return trace.summarize([(e.name, e.cat, e.start, e.end) for e in events])


@contextlib.contextmanager
def collecting():
    """Drivers that open a `perfbench.trace.Tracer` get a `SpanTracer`; yields
    the list its SpanSummaries are appended to."""
    found = []

    class Collecting(SpanTracer):
        def summary(self):
            out = super().summary()
            found.append(self.spans)
            return out

    orig = trace.Tracer
    trace.Tracer = Collecting
    try:
        yield found
    finally:
        trace.Tracer = orig


def run_cell(run: harness.Run) -> dict:
    """The result of a traced run of the cell, with its `spans` report."""
    with collecting() as found:
        result = harness.execute(run)
    unit = "view" if run.cell.traffic["driver"] == "view" else "step"
    if found:
        result["spans"] = found[-1].report(result["attempted"], unit)
    return result


def main(argv=None):
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(prog="python3 -m perfbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=35.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.prepare_process()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.spans: no result: CUDA is not available", file=sys.stderr)
        return 2
    result = run_cell(harness.Run(cell, args.seed, args.seconds, True, "cuda", t_start))
    line = json.dumps({"workload": args.workload, "seed": args.seed, **result})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
