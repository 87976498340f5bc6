"""Export a parameters-only "slim" checkpoint from a trained experiment.

    python -m outdoor_nerf_depth_torch.tools.slim_checkpoint <exp_dir> [out.pt] \\
        [--keep-occupancy]

The port's counterpart of the repository's `tools/slim_checkpoint.py`: the
latest checkpoint of `exp_dir` (read with its `config.json`) without the
optimizer's state and the generator, one `torch.save` file (`exp_dir/slim.pt`
unless `out` is given) holding the parameters, the model-identity meta and
the step. `--keep-occupancy` embeds an NGP model's occupancy grid. An
experiment without a checkpoint is an error. Restore it by pointing any
entry point at it:

    python -m outdoor_nerf_depth_torch.tools.eval --config <exp_dir>/config.json \\
        slim_checkpoint=<out>

It reads and writes files on the CPU and runs nothing on a device.
"""

from __future__ import annotations

import os
import sys

from outdoor_nerf_depth_torch.models.ngp import HashGridModel
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import load_config


def main(argv):
    args = [a for a in argv if not a.startswith("--")]
    keep_occ = "--keep-occupancy" in argv
    if not args:
        raise SystemExit(__doc__)
    exp_dir = args[0]
    out = args[1] if len(args) > 1 else os.path.join(exp_dir, "slim.pt")

    config = load_config(os.path.join(exp_dir, "config.json"))
    config = config.replace(exp_dir=exp_dir, slim_checkpoint="")
    model, step = step_lib.load_checkpoint(config)
    if step == 0:
        raise SystemExit(f"no checkpoint found under {exp_dir}/checkpoints")
    occupancy = model.occupancy if isinstance(model, HashGridModel) else None
    ckpt_lib.export_slim(
        out,
        dict(model.named_parameters()),
        occupancy=occupancy if keep_occ else None,
        meta=step_lib.checkpoint_meta(config, model),
        step=step,
    )
    size_mb = os.path.getsize(out) / 1e6
    print(f"wrote {out} (step {step}, {size_mb:.1f} MB, "
          f"occupancy={'kept' if keep_occ and occupancy is not None else 'dropped'})")


if __name__ == "__main__":
    main(sys.argv[1:])
