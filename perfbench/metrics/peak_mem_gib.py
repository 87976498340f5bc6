"""Largest memory the allocator held on the card during the window
(`torch.cuda.max_memory_allocated` after a reset at the window's start), GiB."""


def read(run, measured):
    peak = measured.counters.get("window_peak_bytes")
    return peak / 2**30 if peak else None
