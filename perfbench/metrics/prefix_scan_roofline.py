"""Share of the prefix-scan kernel's roofline (K2a, `csrc/prefix_scan.cu`)
over the traced window: one launch a hash level and step over [field
points, 8 corners x features] float32, HBM-bound at 8 B an element, over
the launches' summed device time."""

from perfbench import flops


def read(run, measured):
    c, t = measured.counters, measured.trace
    if t is None or c.get("model") != "ngp" or not c.get("steps"):
        return None
    spent = t.device_s("prefix_scan")
    if spent <= 0:
        return None
    bound = flops.ngp_scan_bound_s(c["model_params"], c["batch_size"]) * c["steps"]
    return 100.0 * bound / spent
