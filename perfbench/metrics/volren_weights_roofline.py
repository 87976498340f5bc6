"""Share of the compositing-weight kernels' roofline (K1a forward, K1b
backward, `csrc/volren_weights.cu`) over the traced window: the least time
their launches need, from each level's [batch, samples] shape and the
bytes each element moves (HBM-bound: 12 B forward, 16 B backward), over
their summed device time. One K1a and one K1b a level and step."""

from perfbench import flops


def read(run, measured):
    c, t = measured.counters, measured.trace
    if t is None or c.get("model") != "mipnerf360" or not c.get("steps"):
        return None
    spent = t.device_s("volren_weights")
    if spent <= 0:
        return None
    bound = flops.mip_volren_bound_s(c["model_params"], c["batch_size"]) * c["steps"]
    return 100.0 * bound / spent
