"""Prior generation: run a depth net over a scene, write uint16 depth PNGs.

Port of the reference package's `depth_priors/generate.py`: stereo or
completion nets -> uint16 PNG (metres * 256) -> the scene's
`depths_<prior>_crop/` folders that the NeRF data layer reads. Each call
builds its model once, loads `params` (a state dict of that model) and
runs every image under `torch.inference_mode()`, padded to a multiple of
32. Runs on CUDA unless `device="cpu"` is given.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from outdoor_nerf_depth_torch.data.datasets import load_image
from outdoor_nerf_depth_torch.depth_priors import completion, stereo
from outdoor_nerf_depth_torch.train.loop import resolve_device
from outdoor_nerf_depth_torch.utils.image import save_depth_u16

COMPLETION_ARCHS = {"guided": completion.GuidedCompletionNet,
                    "resnet": completion.DepthCompletionNet}


def _pad_to_multiple(img, multiple: int = 32):
    h, w = img.shape[:2]
    ph, pw = (-h) % multiple, (-w) % multiple
    widths = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, widths), (h, w)


def _load_model(model: torch.nn.Module, params: Mapping, device) -> torch.nn.Module:
    model.load_state_dict(params)
    return model.to(device).eval()


def _batch(img, device):
    """One padded float32 image as a [1, ...] tensor on `device`."""
    padded, _ = _pad_to_multiple(img.astype(np.float32))
    return torch.from_numpy(padded)[None].to(device)


def build_completion_net(arch: str, generator: Optional[torch.Generator] = None,
                         dtype: torch.dtype = torch.float32):
    if arch not in COMPLETION_ARCHS:
        raise ValueError(f"unknown completion arch {arch!r}")
    return COMPLETION_ARCHS[arch](generator=generator, dtype=dtype)


def generate_stereo_priors(
    params: Mapping,
    left_dir: str,
    right_dir: str,
    out_dir: str,
    focal: float,
    baseline: float,
    variant: str = "cfnet",
    max_disparity: int = 192,
    confidence_threshold: float = 0.0,
    model_kwargs: Optional[dict] = None,
    log_fn=print,
    device=None,
):
    """Run the stereo net over paired directories (zipped in sorted order);
    write depth PNGs named after the left images.

    With `confidence_threshold > 0`, low-confidence pixels are zeroed: the
    `ste_conf` prior (92.28% density in the paper's Table 4).
    """
    device = resolve_device(device)
    model = _load_model(stereo.StereoNet(variant=variant, max_disparity=max_disparity,
                                         **(model_kwargs or {})), params, device)
    os.makedirs(out_dir, exist_ok=True)
    lefts = sorted(os.listdir(left_dir))
    rights = sorted(os.listdir(right_dir))
    for lname, rname in zip(lefts, rights):
        left = load_image(os.path.join(left_dir, lname)) / 255.0
        right = load_image(os.path.join(right_dir, rname)) / 255.0
        h, w = left.shape[:2]
        with torch.inference_mode():
            out = model(_batch(left, device), _batch(right, device))
            disp = out["disparity"][0, :h, :w]
            conf = out["confidence"][0, :h, :w]
            depth = stereo.disparity_to_depth(disp, focal, baseline)
            if confidence_threshold > 0:
                depth = torch.where(conf >= confidence_threshold, depth, torch.zeros_like(depth))
        depth, disp = depth.cpu().numpy(), disp.cpu().numpy()
        save_depth_u16(depth, os.path.join(out_dir, os.path.splitext(lname)[0] + ".png"))
        log_fn(f"{lname}: disp [{disp.min():.1f}, {disp.max():.1f}] "
               f"density {(depth > 0).mean():.2%}")


def generate_completion_priors(
    params: Mapping,
    image_dir: str,
    sparse_depth_dir: str,
    out_dir: str,
    arch: str = "guided",
    log_fn=print,
    device=None,
):
    """Complete sparse LiDAR depth maps (uint16 PNGs of the images' names);
    write dense depth PNGs."""
    device = resolve_device(device)
    model = _load_model(build_completion_net(arch), params, device)
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(image_dir)):
        stem = os.path.splitext(name)[0]
        rgb = load_image(os.path.join(image_dir, name)) / 255.0
        sparse = load_image(os.path.join(sparse_depth_dir, stem + ".png")) / 256.0
        h, w = rgb.shape[:2]
        with torch.inference_mode():
            dense = model(_batch(rgb, device), _batch(sparse, device))[0, :h, :w]
        dense = dense.cpu().numpy()
        save_depth_u16(dense, os.path.join(out_dir, stem + ".png"))
        log_fn(f"{name}: depth [{dense.min():.1f}, {dense.max():.1f}] m")
