"""Host milliseconds a view in the port's `view.cast` span (the viewer's ray
cast on the host, `tools/viewer.py:view_batch`) over the traced window, from
the program's own record."""

from perfbench import program_record


def read(run, measured):
    return program_record.span_ms_per(measured, "view.cast", "views")
