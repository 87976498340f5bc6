"""Host milliseconds a train step in the port's `loop.batch` span (the wait
on the prefetch queue and the copy of the batch to the card) over the
traced window, from the program's own record."""

from perfbench import program_record


def read(run, measured):
    return program_record.span_ms_per(measured, "loop.batch", "steps")
