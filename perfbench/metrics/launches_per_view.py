"""Kernel launches (not copies or sets) in the traced window over its views."""


def read(run, measured):
    if measured.trace is None or not measured.counters.get("views"):
        return None
    return measured.trace.launches / measured.counters["views"]
