"""Dense-layer FLOPs of the traced window's NeRF++ train steps (forward on
every level's foreground and background points, backward twice it but for
each MLP's first layer, from the configuration's shapes:
`perfbench/flops_nerfpp.py`) over the window's host time, as a share of the
card's published peak at the configuration's precision (67 TFLOP/s float32
with TF32 off) times the cell's cards. Where the port counts its field
points (`nerfpp.points`), the count must be the configuration's points a
ray times the window's rays, or nothing is read."""

from perfbench import flops, flops_nerfpp, program_record


def read(run, measured):
    c, t = measured.counters, measured.trace
    if t is None or c.get("model") != "nerfpp" or not c.get("steps") or t.window_s <= 0:
        return None
    mp = c["model_params"]
    record = program_record.snapshot(measured)
    if record is not None and "nerfpp.points" in record["counters"]:
        expected = flops_nerfpp.points_per_ray(mp) * c["batch_size"] * c["steps"]
        if record["counters"]["nerfpp.points"] != expected:
            return None
    per_step = flops_nerfpp.nerfpp_train_flops(mp, c["batch_size"])
    peak = flops.PEAK_FLOPS_PER_S[c["precision"]] * c["chips"]
    return 100.0 * per_step * c["steps"] / t.window_s / peak
