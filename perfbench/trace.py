"""The traced window: torch.profiler over a stretch of the run, reduced to
device intervals, kernel counts by name and kind, and idle gaps labelled
by the host op that ran during each.

The window is marked by a profiler range the harness opens and closes
(`MARK`), so its bounds are on the trace's own clock. Device time is the
union of kernel, copy and set intervals inside it: overlapping kernels
count once.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

from perfbench import flops, stats

MARK = "perfbench_window"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int  # kernels (not copies or sets) that started in the window
    device_s_by_name: dict
    device_s_by_kind: dict
    launches_by_kind: dict
    idle_by_host_op: dict

    def device_s(self, kind: str) -> float:
        return self.device_s_by_kind.get(kind, 0.0)

    def breakdown(self) -> dict:
        top = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, s in top],
                "idle_gaps": [[name[:160], s] for name, s in idle]}


class Tracer:
    """Start and stop a profiler around a window that opens and closes in
    different callbacks; `summary()` after `stop()`.

    The events are read from the profiler's Chrome trace, whose `cat` field
    tells kernels, copies and sets from annotations and syncs on every
    PyTorch version (the kineto event objects of some lack that field). The
    file goes under TMPDIR and is removed once read."""

    def __init__(self, device: str = "cuda"):
        import torch

        self._torch = torch
        self._card = device == "cuda"
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self._range = None

    def start(self):
        self.prof.start()
        self._range = self._torch.autograd.profiler.record_function(MARK)
        self._range.__enter__()

    def stop(self):
        if self._card:
            self._torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> Summary:
        fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        events = raw["traceEvents"] if isinstance(raw, dict) else raw
        return summarize([(e["name"], e.get("cat", ""), int(round(e["ts"] * 1e3)),
                           int(round((e["ts"] + e["dur"]) * 1e3)))
                          for e in events if e.get("ph") == "X" and "dur" in e])


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")  # not annotations or syncs
HOST_OPS = ("cpu_op", "user_annotation", "python_function")


def summarize(events, max_gaps: int = 4000, scan_back: int = 4000) -> Summary:
    """Reduce (name, category, start ns, end ns) events of a Chrome trace
    to a Summary of the MARK range. Device work is kernels, copies and
    sets; the GPU's annotation ranges and sync records are not work and
    are left out."""
    device, host = [], []
    w0 = w1 = None
    for name, kind, start, end in events:
        if kind in DEVICE_WORK:
            device.append((start, end, name, kind == "kernel"))
        elif name == MARK and kind == "user_annotation":
            w0, w1 = start, end
        elif kind in HOST_OPS:
            host.append((start, end, name))
    if w0 is None:
        raise ValueError("the trace holds no window mark")
    device = [(max(s, w0), min(t, w1), n, k) for s, t, n, k in device if t > w0 and s < w1]
    by_name, by_kind, launches_by_kind = defaultdict(float), defaultdict(float), defaultdict(int)
    launches = 0
    for s, t, n, is_kernel in device:
        by_name[n] += (t - s) * 1e-9
        if not is_kernel:
            kind = "copy"
        else:
            kind = flops.kernel_kind(n)
            launches += 1
            launches_by_kind[kind] += 1
        by_kind[kind] += (t - s) * 1e-9
    intervals = [(s, t) for s, t, _, _ in device]
    busy = stats.union_length(intervals) * 1e-9
    idle = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    holes = sorted(stats.gaps(intervals, w0, w1), key=lambda g: g[0] - g[1])[:max_gaps]
    for a, b in holes:
        mid = 0.5 * (a + b)
        label = "no torch op on the host"
        # The latest-starting host op still running at the gap's middle.
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - scan_back), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] += (b - a) * 1e-9
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy, launches=launches,
                   device_s_by_name=dict(by_name), device_s_by_kind=dict(by_kind),
                   launches_by_kind=dict(launches_by_kind), idle_by_host_op=dict(idle))
