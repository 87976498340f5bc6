"""Device milliseconds a train step of the kernels the classifier
(`perfbench/flops.py:KERNEL_KINDS`) calls gather_scatter: the hash grid's
row gathers and the marching's compaction."""


def read(run, measured):
    t = measured.trace
    if t is None or not measured.counters.get("steps") or "gather_scatter" not in t.device_s_by_kind:
        return None
    return 1e3 * t.device_s("gather_scatter") / measured.counters["steps"]
