"""Rendered samples a ray of an NGP model over every train step or render
chunk of the traced window: the port's `ngp.samples` counter (each step's
`vr_s` times its rays, each chunk's per-ray sample counts) over its
`ngp.rays` counter."""

from perfbench import program_record


def read(run, measured):
    record = program_record.snapshot(measured)
    if record is None:
        return None
    counters = record["counters"]
    if not counters.get("ngp.rays") or "ngp.samples" not in counters:
        return None
    return counters["ngp.samples"] / counters["ngp.rays"]
