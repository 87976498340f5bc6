"""Dense-layer FLOPs of the traced window's train steps (forward and
backward from the configuration's layer shapes; an NGP step's field points
from its own rendered-samples counter vr_s) over the window's host time, as
a share of the card's published peak at the configuration's precision
(67 TFLOP/s float32 with TF32 off, 989 bf16), times the cell's cards."""

from perfbench import flops


def read(run, measured):
    c, t = measured.counters, measured.trace
    if t is None or not c.get("steps") or t.window_s <= 0:
        return None
    if c["model"] == "mipnerf360":
        per_step = flops.mip_train_flops(c["model_params"], c["batch_size"])
    elif c["model"] == "ngp" and c.get("vr_s"):
        vr = sum(c["vr_s"]) / len(c["vr_s"])
        per_step = flops.ngp_train_flops(c["model_params"], c["batch_size"], vr)
    else:
        return None
    peak = flops.PEAK_FLOPS_PER_S[c["precision"]] * c["chips"]
    return 100.0 * per_step * c["steps"] / t.window_s / peak
