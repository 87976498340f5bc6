"""Host milliseconds a train step in the port's NeRF++ field spans
(`nerfpp.fg` plus `nerfpp.bg`: each level's points, field MLP and
compositing, `models/nerfpp.py`) over the traced window, from the program's
own record."""

from perfbench import program_record

SPANS = ("nerfpp.fg", "nerfpp.bg")


def read(run, measured):
    parts = [program_record.span_ms_per(measured, span, "steps") for span in SPANS]
    if any(part is None for part in parts):
        return None
    return sum(parts)
