"""Kernel launches (not copies or sets) in the traced window over its train steps."""


def read(run, measured):
    if measured.trace is None or not measured.counters.get("steps"):
        return None
    return measured.trace.launches / measured.counters["steps"]
