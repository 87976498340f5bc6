"""Device milliseconds a train step of the collective (NCCL) kernels on
rank 0's card: the one flat gradient all-reduce and the loop's small ones."""


def read(run, measured):
    t = measured.trace
    if t is None or not measured.counters.get("steps") or "collective" not in t.device_s_by_kind:
        return None
    return 1e3 * t.device_s("collective") / measured.counters["steps"]
