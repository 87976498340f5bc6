"""Spans and counters of the port, on the profiler's clock.

`span(name)` marks a stretch of the program. While a `torch.profiler`
records on the calling thread (the loop's `profile_start_step` window, or
any profiler a caller opens), it opens `torch.profiler.record_function`,
so the span lands in the same Chrome trace as the kernels it launches,
nested in the spans around it; it also adds its host time to the record
below. When no profiler records, it returns one shared no-op context after
a single check: a span then costs a fraction of a microsecond, where
`record_function` alone costs several even with no profiler.

`count(name, value, scale)` adds `value` (a number, or a tensor whose
elements are summed) times `scale` to a counter, again only while a
profiler records. A tensor is kept by reference and read in `snapshot()`,
so a count launches no kernel and waits for no device.

The record (counters, and each span name's count and inclusive host
seconds) covers one stretch of recording: the first span or count made
under a profiler after the profiler was off clears it. `reset()` clears it
by hand; `snapshot()` returns it as plain numbers after one wait per
device holding a counted tensor.

Names follow the layer: `loop.*` (train/loop.py), `step.*` (the train
step's phases), `ngp.*`, `mip.*` and `nerfpp.*` (the models), `render.*`
and `view.*` (the renderer and the viewer), and the hash grid's counters
`hashgrid.fwd_levels` and `hashgrid.grad_levels` (`ops/hashgrid.py`: the
levels one osplit forward encodes, or one backward folds, in one pass). The span names are part of what traces and
their readers rely on: rename one only with its readers.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

_thread_records = torch._C._autograd._profiler_enabled  # a profiler records on this thread
_NOOP = contextlib.nullcontext()


class _Record:
    """What the spans and counters of one stretch of recording add up."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live = False  # a stretch of recording is open
        self.clear()

    def clear(self):
        self.counts = defaultdict(list)  # name -> [(value, scale)]
        self.spans = defaultdict(lambda: [0, 0])  # name -> [count, host ns]

    def begin(self):
        """Called under a profiler: the first call of a stretch clears the record."""
        if not self.live:
            with self.lock:
                if not self.live:
                    self.clear()
                    self.live = True

    def end_if_stopped(self):
        """Called with no profiler on this thread: a stretch ends once no
        profiler runs in the process (another thread may not record while
        one does)."""
        if not torch.autograd.profiler._is_profiler_enabled:
            self.live = False


_record = _Record()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _record.begin()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        with _record.lock:
            entry = _record.spans[self.name]
            entry[0] += 1
            entry[1] += elapsed
        return False


def span(name: str):
    """A context marking `name` in the profiler's trace; a shared no-op without one."""
    if _thread_records():
        return _Span(name)
    if _record.live:
        _record.end_if_stopped()
    return _NOOP


def count(name: str, value, scale: float = 1.0):
    """Add `value` x `scale` to counter `name` while a profiler records; a
    tensor's elements are summed when the record is read."""
    if not _thread_records():
        if _record.live:
            _record.end_if_stopped()
        return
    _record.begin()
    if isinstance(value, torch.Tensor):
        value = value.detach()
    with _record.lock:
        _record.counts[name].append((value, float(scale)))


def reset():
    """Clear the counters and span totals."""
    with _record.lock:
        _record.clear()


def snapshot() -> dict:
    """{"counters": {name: total}, "spans": {name: {"count": n, "host_s": s}}}
    of the current stretch of recording, as plain numbers."""
    with _record.lock:
        counts = {k: list(v) for k, v in _record.counts.items()}
        spans = {k: {"count": n, "host_s": ns * 1e-9} for k, (n, ns) in _record.spans.items()}
    totals = {name: sum(s * v for v, s in terms if not isinstance(v, torch.Tensor))
              for name, terms in counts.items()}
    by_device = defaultdict(list)  # device -> [(name, summed tensor)]
    for name, terms in counts.items():
        for v, s in terms:
            if isinstance(v, torch.Tensor):
                by_device[v.device].append((name, v.to(torch.float64).sum() * s))
    for parts in by_device.values():
        values = torch.stack([t for _, t in parts]).cpu().tolist()  # the one wait
        for (name, _), v in zip(parts, values):
            totals[name] += v
    return {"counters": {k: float(v) for k, v in totals.items()}, "spans": spans}
