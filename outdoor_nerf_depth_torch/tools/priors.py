"""Generate depth priors for a scene (stereo or completion).

    python -m outdoor_nerf_depth_torch.tools.priors stereo --left DIR --right DIR \\
        --out DIR --focal 718.856 --baseline 0.54 [--variant cfnet|pcwnet] \\
        [--max-disparity 192] [--conf-threshold 0.5] [--params stereo.pt] [--device cpu]
    python -m outdoor_nerf_depth_torch.tools.priors complete --images DIR \\
        --sparse DIR --out DIR [--arch guided|resnet] [--params completion.pt] [--device cpu]

The port's counterpart of the repository's `priors.py`, with its arguments.
`--params` is a state dict that `tools/train_prior.py` saved with
`torch.save` (the reference saves Flax msgpack). Without it the nets run
with random weights made from seed 0 (a shape smoke only: train or load
weights for real priors). Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from outdoor_nerf_depth_torch.depth_priors import generate, stereo


def load_params(path, model: torch.nn.Module):
    """The state dict saved at `path`, or `model`'s own (random) one."""
    if path is None:
        print("WARNING: no --params given; using random weights")
        return model.state_dict()
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv):
    p = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.tools.priors")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("stereo")
    s.add_argument("--left", required=True)
    s.add_argument("--right", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--focal", type=float, required=True)
    s.add_argument("--baseline", type=float, required=True)
    s.add_argument("--variant", default="cfnet", choices=["cfnet", "pcwnet"])
    s.add_argument("--max-disparity", type=int, default=192)
    s.add_argument("--conf-threshold", type=float, default=0.0)
    s.add_argument("--params", default=None)

    c = sub.add_parser("complete")
    c.add_argument("--images", required=True)
    c.add_argument("--sparse", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--arch", default="guided", choices=sorted(generate.COMPLETION_ARCHS))
    c.add_argument("--params", default=None)

    for sp in (s, c):
        sp.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without it)")
    args = p.parse_args(argv)

    generator = torch.Generator().manual_seed(0)
    if args.cmd == "stereo":
        model = stereo.StereoNet(variant=args.variant, max_disparity=args.max_disparity,
                                 generator=generator)
        generate.generate_stereo_priors(
            load_params(args.params, model), args.left, args.right, args.out,
            focal=args.focal, baseline=args.baseline, variant=args.variant,
            max_disparity=args.max_disparity, confidence_threshold=args.conf_threshold,
            device=args.device,
        )
    else:
        model = generate.build_completion_net(args.arch, generator)
        generate.generate_completion_priors(
            load_params(args.params, model), args.images, args.sparse, args.out,
            arch=args.arch, device=args.device,
        )


if __name__ == "__main__":
    main(sys.argv[1:])
