"""The port's own record of the traced window: its spans' host seconds and
its counters (`outdoor_nerf_depth_torch/utils/tracing.py`).

The port records them only while a profiler records, and a new stretch of
recording clears them, so after a `--trace 1` run they cover the window.
A program without that module (or an untraced run) has no record: None.
"""


def snapshot(measured):
    """{"counters": {...}, "spans": {name: {"count", "host_s"}}} or None."""
    if measured.trace is None:
        return None
    try:
        from outdoor_nerf_depth_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def span_ms_per(measured, span: str, unit: str):
    """Host milliseconds in `span` over the window's `unit` ("steps", "views"), or None."""
    record, n = snapshot(measured), measured.counters.get(unit)
    if record is None or not n or span not in record["spans"]:
        return None
    return 1e3 * record["spans"][span]["host_s"] / n
