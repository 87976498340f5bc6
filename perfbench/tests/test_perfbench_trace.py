"""The trace reduction on made-up events: the window mark, device work
against annotations and syncs, the union of busy intervals, launches and
idle gaps labelled by the host op."""

import pytest

from perfbench import trace


def E(name, kind, start, end):
    return (name, kind, start, end)


def test_summary_of_a_window():
    ev = [
        E(trace.MARK, "user_annotation", 1000, 11000),
        E(trace.MARK, "gpu_user_annotation", 1000, 11000),  # not work
        E("cudaStreamSynchronize", "cuda_sync", 5000, 9000),  # not work
        E("weights_fwd_kernel", "kernel", 1000, 3000),
        E("sm90_xmma_gemm", "kernel", 2000, 4000),  # overlaps: counted once
        E("Memcpy HtoD", "gpu_memcpy", 9000, 10000),
        E("weights_bwd_kernel", "kernel", 500, 1500),  # clipped at the window
        E("aten::item", "cpu_op", 4100, 8900),
        E("aten::mm", "cpu_op", 1500, 1600),
    ]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(10000e-9)
    assert s.busy_s == pytest.approx((3000 + 1000) * 1e-9)
    assert s.launches == 3
    assert s.device_s("volren_weights") == pytest.approx((2000 + 500) * 1e-9)
    assert s.device_s("copy") == pytest.approx(1000e-9)
    assert s.idle_by_host_op["aten::item"] == pytest.approx(5000e-9)
    assert s.idle_by_host_op["no torch op on the host"] == pytest.approx(1000e-9)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "weights_fwd_kernel" and len(b["idle_gaps"]) == 2


def test_no_mark_is_an_error():
    with pytest.raises(ValueError):
        trace.summarize([E("k", "kernel", 0, 1)])
