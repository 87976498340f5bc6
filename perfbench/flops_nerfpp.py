"""Dense-layer FLOPs of a NeRF++ train step, from the configuration's shapes.

Every cascade level evaluates a foreground point MLP (3-D points inside
the unit sphere) and a background one (the inverted sphere's 4-D points)
on all of the level's samples: level 0 on its own, each later level on its
new samples and the earlier ones merged. The layer shapes are the plain
reference's (`reference/nerfpp.py:mlp_layers`): counted from the
configuration's keys, never from the program's modules.
"""

from __future__ import annotations

from perfbench import flops
from perfbench.reference import nerfpp as nerfpp_ref


def samples_per_level(model_params: dict):
    """Samples a ray of each level, foreground and background alike."""
    out, n = [], 0
    for new in model_params.get("cascade_samples", (64, 128)):
        n += new
        out.append(n)
    return out


def points_per_ray(model_params: dict) -> int:
    """Field points a ray over the cascade, foreground plus background."""
    return 2 * sum(samples_per_level(model_params))


def nerfpp_train_flops(model_params: dict, batch: int) -> float:
    """Forward on every level's points, backward twice the forward for every
    layer but each MLP's first (its input, the encoding, needs no gradient)."""
    total = 0.0
    for samples in samples_per_level(model_params):
        for input_dim in (3, 4):
            layers = [(fan_in, fan_out)
                      for _, fan_in, fan_out in nerfpp_ref.mlp_layers(model_params, input_dim)]
            points = batch * samples
            total += 3 * flops.linear_flops(layers, points) - flops.linear_flops(layers[:1], points)
    return total
