"""Train a depth-prior network (stereo or completion).

    python -m outdoor_nerf_depth_torch.tools.train_prior stereo --data ROOT \\
        [--variant cfnet|pcwnet] [--steps 20000] [--batch 2] [--lr 1e-3] \\
        [--crop 256 512] [--out stereo.pt] [--list-file LIST | --benchmark NAME \\
        [--split SPLIT]] [--eval-list LIST] [--seed 0] [--device cpu]
    python -m outdoor_nerf_depth_torch.tools.train_prior complete --data ROOT \\
        [--arch guided|resnet] [--smooth-weight 0.01] [--photo [--photo-weight 0.1]] ...

The port's counterpart of the repository's `train_prior.py`, with its
arguments: Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8, no
clipping) over the folder-layout datasets (`depth_priors/datasets.py`), the
reference-format list files or a benchmark's directory scan
(`depth_priors/benchmark_data.py`); `--eval-list` reports EPE and D1 after
training. `--out` saves the model's state dict with `torch.save`, which
`tools/priors.py --params` loads. The nets start from random weights made
from `--seed` (default 0; the batches do not depend on it). The reference
has no such option: it always starts from PRNG key 0, a draw that torch's
generator cannot reproduce. At the default learning rate the completion
nets' output ReLU dies on the first steps for many initialisations, in
the reference too, and the prior is then all zero: another seed is the
remedy. Training is not bit-reproducible on CUDA at a fixed seed (the
backward of bilinear upsampling, for one, accumulates with atomics), so
the same seed gives another prior on another run. `--photo` adds the
photometric self-supervision: every batch after the first comes with each
crop's temporal neighbour and their PnP pose
(`CompletionDataset.sample_batch_with_near`, pose estimation on the host),
and the loss gains `--photo-weight` times the L1 error of the neighbour
inverse-warped through the predicted depth (`depth_priors/pose.py`), over
the pixels that land inside it on items whose PnP succeeded. Runs on CUDA
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from outdoor_nerf_depth_torch.depth_priors import benchmark_data, completion
from outdoor_nerf_depth_torch.depth_priors import datasets as prior_data
from outdoor_nerf_depth_torch.depth_priors import generate, pose, stereo
from outdoor_nerf_depth_torch.train.loop import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m outdoor_nerf_depth_torch.tools.train_prior")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("stereo", "complete"):
        q = sub.add_parser(name)
        q.add_argument("--data", required=True)
        q.add_argument("--steps", type=int, default=20000)
        q.add_argument("--batch", type=int, default=2)
        q.add_argument("--lr", type=float, default=1e-3)
        q.add_argument("--crop", type=int, nargs=2, default=(256, 512))
        q.add_argument("--out", default=None)
        q.add_argument("--print-every", type=int, default=50)
        q.add_argument("--seed", type=int, default=0, help="seed of the initial weights")
        q.add_argument("--device", default=None,
                       help="torch device (default cuda; raises without it)")
        if name == "stereo":
            q.add_argument("--variant", default="cfnet", choices=["cfnet", "pcwnet"])
            q.add_argument("--max-disparity", type=int, default=192)
            q.add_argument("--list-file", default=None,
                           help="reference-format filename list (`left right [disp]` rows, "
                           "paths relative to --data) in place of the folder layout")
            q.add_argument("--benchmark", default=None, choices=sorted(benchmark_data.SCANNERS),
                           help="scan --data in this benchmark's directory layout")
            q.add_argument("--split", default=None,
                           help="benchmark split for --benchmark scans (e.g. training / TRAIN)")
            q.add_argument("--eval-list", default=None,
                           help="after training, report EPE/D1 over this filename list")
        else:
            q.add_argument("--arch", default="guided", choices=sorted(generate.COMPLETION_ARCHS))
            q.add_argument("--photo", action="store_true",
                           help="add self-supervised photometric loss (PnP pose + inverse warp "
                           "from the temporal neighbor)")
            q.add_argument("--photo-weight", type=float, default=0.1)
            q.add_argument("--smooth-weight", type=float, default=0.01)
    return p


def stereo_dataset(args):
    crop = tuple(args.crop)
    if args.list_file:
        return benchmark_data.StereoBenchmarkDataset.from_list_file(args.data, args.list_file,
                                                                    crop=crop)
    if args.benchmark:
        kw = {"crop": crop}
        if args.split:
            kw["split"] = args.split
        return benchmark_data.StereoBenchmarkDataset.from_scan(args.data, args.benchmark, **kw)
    return prior_data.StereoPairDataset(args.data, crop=crop)


def stereo_loss(model, max_disparity: float):
    def loss_fn(left, right, disp):
        return stereo.multi_scale_loss(model(left, right), disp, max_disparity)
    return loss_fn


def completion_loss(model, smooth_weight: float):
    def loss_fn(rgb, sparse, gt):
        pred = model(rgb, sparse)
        return (completion.masked_depth_mse(pred, gt)
                + smooth_weight * completion.edge_aware_smoothness(pred, rgb))
    return loss_fn


def photo_completion_loss(model, smooth_weight: float, photo_weight: float):
    """`completion_loss` plus `photo_weight` times the photometric error of
    the neighbour warped into each item's view through the predicted depth,
    masked to the pixels that land inside it on items whose PnP succeeded."""
    def loss_fn(rgb, sparse, gt, rgb_near, R, t, success, K):
        pred = model(rgb, sparse)
        loss = completion.masked_depth_mse(pred, gt)
        loss = loss + smooth_weight * completion.edge_aware_smoothness(pred, rgb)
        warped, valid = pose.inverse_warp(rgb_near, pred, R, t, K)
        valid = valid & (success[:, None, None] > 0)
        return loss + photo_weight * completion.photometric_loss(warped, rgb, mask=valid)
    return loss_fn


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults: betas (0.9, 0.999), eps 1e-8, no clipping."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(optimizer: torch.optim.Optimizer, loss_fn, batch):
    """One Adam step on `batch` (tensors on the model's device); returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(*batch)
    loss.backward()
    optimizer.step()
    return loss.detach()


def to_device(batch, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)


def evaluate_stereo(model, data: str, eval_list: str, max_disparity: float, device):
    """Mean EPE and D1 over the list's images with valid ground truth
    (each in the benchmark's canonical eval shape)."""
    eval_ds = benchmark_data.StereoBenchmarkDataset.from_list_file(data, eval_list, augment=False)
    totals, n_images = {"epe": 0.0, "d1": 0.0}, 0
    model.eval()
    for i in range(len(eval_ds)):
        b = eval_ds.eval_batch(i)
        with torch.inference_mode():
            left, right = to_device((b["left"], b["right"]), device)
            pred = model(left, right)["disparity"].cpu().numpy()
        m = benchmark_data.disparity_metrics(pred[0], b["disparity"][0], b["valid"][0],
                                             max_disp=max_disparity)
        if m["n_valid"] == 0:
            continue
        totals = {k: totals[k] + m[k] for k in totals}
        n_images += 1
    return {k: round(v / max(n_images, 1), 4) for k, v in totals.items()}, n_images


def main(argv):
    """Train as the arguments say; returns the trained model."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    generator = torch.Generator().manual_seed(args.seed)
    if args.cmd == "stereo":
        ds = stereo_dataset(args)
        model = stereo.StereoNet(variant=args.variant, max_disparity=args.max_disparity,
                                 generator=generator)
        loss_fn = stereo_loss(model, args.max_disparity)
    else:
        ds = prior_data.CompletionDataset(args.data, crop=tuple(args.crop))
        model = generate.build_completion_net(args.arch, generator)
        if args.photo:
            loss_fn = photo_completion_loss(model, args.smooth_weight, args.photo_weight)
        else:
            loss_fn = completion_loss(model, args.smooth_weight)
    photo = args.cmd == "complete" and args.photo
    sample = ds.sample_batch_with_near if photo else ds.sample_batch
    # The reference draws one batch (without neighbours) to initialise its
    # model; drawing it here too keeps step i on the reference's batch i.
    ds.sample_batch(args.batch)
    model.to(device).train()
    optimizer = make_optimizer(model, args.lr)

    t0 = time.perf_counter()
    for step in range(args.steps):
        loss = train_step(optimizer, loss_fn, to_device(sample(args.batch), device))
        if (step + 1) % args.print_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {step + 1}: loss {float(loss):.4f} ({args.print_every / dt:.2f} it/s)",
                  flush=True)
            t0 = time.perf_counter()

    if args.out:
        torch.save(model.state_dict(), args.out)
        print(f"saved params to {args.out}")

    if args.cmd == "stereo" and args.eval_list:
        mean, n_images = evaluate_stereo(model, args.data, args.eval_list, args.max_disparity,
                                         device)
        print(f"eval [{args.eval_list}]: n={n_images} EPE {mean['epe']} D1 {mean['d1']}",
              flush=True)
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
