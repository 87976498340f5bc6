"""The reduction of a traced window by the program's spans (`perfbench/spans.py`)
on made-up events: containment on one thread, spans of other threads
ignored, device time through the correlation of a launch, idle by the
innermost span, synchronizations outside every span left out; and a traced
CPU run through the harness, whose line gains the report."""

import pytest

from perfbench import spans as spans_lib
from perfbench import trace
from perfbench.spans import OUTSIDE, Event
from perfbench.tests._tiny import tiny_run

LOOP, OTHER, BACKWARD = 1, 2, 3


def X(name, cat, start_ns, end_ns, tid=LOOP, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": start_ns / 1e3,
         "dur": (end_ns - start_ns) / 1e3, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def window():
    """A 10 us window on the loop thread: loop.step [1000, 9000] holding
    loop.batch [1000, 2000] and step.forward [2000, 6000] holding ngp.field
    [3000, 5000]; the device busy [2500, 3500] and [5500, 6500]."""
    return [
        X(trace.MARK, "user_annotation", 0, 10000),
        X("loop.step", "user_annotation", 1000, 9000),
        X("loop.batch", "user_annotation", 1000, 2000),
        X("step.forward", "user_annotation", 2000, 6000),
        X("ngp.field", "user_annotation", 3000, 5000),
        X("Optimizer.step#Adam.step", "user_annotation", 6000, 7000),  # not the program's
        X("loop.step", "user_annotation", 0, 10000, tid=OTHER),  # another thread's
        X("cudaLaunchKernel", "cuda_runtime", 2100, 2200, corr=7),  # in step.forward
        X("cudaLaunchKernel", "cuda_runtime", 3100, 3200, corr=8),  # in ngp.field
        X("k_forward", "kernel", 2500, 3500, corr=7),
        X("k_field", "kernel", 5500, 6500, corr=8),
        X("cudaStreamSynchronize", "cuda_runtime", 1500, 1600),  # in loop.batch
        X("cudaStreamSynchronize", "cuda_runtime", 9500, 9600),  # outside every span
        X("cudaStreamSynchronize", "cuda_sync", 9500, 9600),  # a device record, not a call
    ]


def summary(extra=()):
    return spans_lib.summarize_spans(spans_lib.events_of({"traceEvents": window() + list(extra)}))


def test_host_seconds_by_span_on_every_thread():
    s = summary()
    assert s.host["loop.step"] == [2, pytest.approx((8000 + 10000) * 1e-9)]  # both threads' spans
    assert s.host["ngp.field"] == [1, pytest.approx(2000e-9)]
    assert "Optimizer.step#Adam.step" not in s.host


def test_device_time_through_the_launch_calls_correlation():
    s = summary()
    assert s.device_s_self == pytest.approx({"step.forward": 1000e-9, "ngp.field": 1000e-9})
    assert s.device_s["loop.step"] == pytest.approx(2000e-9)
    assert s.device_s["step.forward"] == pytest.approx(2000e-9)
    assert s.device_s["ngp.field"] == pytest.approx(1000e-9)


def test_device_work_without_a_launch_call_is_outside():
    s = summary([X("Memcpy HtoD", "gpu_memcpy", 7000, 7500, corr=99)])
    assert s.device_s[OUTSIDE] == pytest.approx(500e-9)


def test_idle_by_the_innermost_span_of_the_loop_thread():
    s = summary()
    # Gaps [0, 2500] (mid 1250: loop.batch), [3500, 5500] (mid 4500: ngp.field),
    # [6500, 10000] (mid 8250: loop.step); the other thread's span is not read.
    assert s.idle_by_span == pytest.approx({"loop.batch": 2500e-9, "ngp.field": 2000e-9,
                                            "loop.step": 3500e-9})
    assert s.idle_s == pytest.approx(10000e-9 - 2000e-9)
    assert sum(s.idle_by_span.values()) == pytest.approx(s.idle_s)
    assert s.idle_outside_compute_s == pytest.approx((2500 + 3500) * 1e-9)


def test_idle_with_no_span_open_is_outside():
    s = spans_lib.summarize_spans(spans_lib.events_of([
        X(trace.MARK, "user_annotation", 0, 1000), X("k", "kernel", 0, 400)]))
    assert s.idle_by_span == pytest.approx({OUTSIDE: 600e-9})
    assert s.idle_outside_compute_s == pytest.approx(600e-9)


def test_syncs_outside_every_span_are_left_out():
    s = summary()
    assert s.syncs_by_span == {"loop.batch": 1, OUTSIDE: 1}
    assert s.syncs_by_name == {"cudaStreamSynchronize": 2}
    assert s.program_syncs() == 1
    report = s.report(per=2, unit="step")
    assert report["derived"]["host_syncs_per_step"] == 0.5


def test_syncs_of_the_step_wrapper_in_loop_step_itself_are_left_out():
    s = summary([X("cudaDeviceSynchronize", "cuda_runtime", 8000, 8100)])  # in loop.step only
    assert s.syncs_by_span["loop.step"] == 1 and s.program_syncs() == 1


def test_a_call_on_a_thread_without_spans_goes_to_the_loop_threads_span():
    s = summary([X("cudaLaunchKernel", "cuda_runtime", 3600, 3700, tid=BACKWARD, corr=9),
                 X("k_bwd", "kernel", 7000, 8000, corr=9),
                 X("cudaStreamSynchronize", "cuda_runtime", 4000, 4100, tid=BACKWARD)])
    assert s.device_s_self["ngp.field"] == pytest.approx(2000e-9)
    assert s.syncs_by_span["ngp.field"] == 1


def test_open_spans_are_nested_outermost_first():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 90, "d")]
    assert spans_lib.open_spans_at(spans, [25, 55, 5, 70, 200]) == [
        ("a", "b", "c"), ("a",), ("a",), ("a", "d"), ()]


def test_no_mark_is_an_error():
    with pytest.raises(ValueError):
        spans_lib.summarize_spans([Event("k", "kernel", 0, 1, LOOP)])


def test_traced_cpu_run_gains_the_report(tmp_path):
    result = spans_lib.run_cell(tiny_run("ngp_kitti.train", tmp_path, trace=True))
    assert result["correct"], result["checks"]
    report = result["spans"]
    assert report["per"] == result["attempted"] > 0
    assert report["host"]["loop.step"][0] == result["attempted"]
    assert {"loop.batch", "step.forward", "ngp.march", "step.optimizer"} <= set(report["host"])
    assert sum(report["idle_by_span"].values()) == pytest.approx(report["idle_s"])
    assert trace.Tracer.__name__ == "Tracer"  # put back
