"""Share of the traced window in which no kernel, copy or set ran on
the card: 1 - (union of device intervals / window), in percent."""


def read(run, measured):
    t = measured.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
