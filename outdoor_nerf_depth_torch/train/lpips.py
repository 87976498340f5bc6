"""LPIPS: VGG16 feature distance with learned linear calibration.

Port of the reference package's `train/lpips.py`, in torch:

    d(x, y) = sum_l  mean_hw  || w_l * (phi_l(x)^ - phi_l(y)^) ||_2^2

where phi_l are VGG16 conv features after relu{1_2, 2_2, 3_3, 4_3, 5_3},
^ is unit-normalization over channels, and w_l >= 0 are the LPIPS
linear-calibration weights. The convolutions are `F.conv2d` (3x3, stride
1, padding 1, which is SAME at stride 1) and the pools 2x2 stride-2 max
pools that drop an odd last row or column, as the reference's VALID
`reduce_window` does (376 -> 188 -> 94 -> 47 -> 23).

Weights are not bundled. They come as the reference's `.npz` file: kernels
`{conv}/kernel` in HWIO [kh, kw, cin, cout] (transposed to torch's OIHW on
load), `{conv}/bias`, `lin{i}/weight` and the exporter's provenance stamp,
found at the path given, else at `ONDT_LPIPS_WEIGHTS`, else at
`weights/lpips_vgg.npz` at the repository root. A missing file, missing
keys and, on a metric path, weights without the stamp raise ValueError.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

# VGG16 conv layout: (name, out_channels, pool_before). LPIPS taps after the
# ReLU of the last conv in each block.
VGG16_CONVS = (
    ("conv1_1", 64, False), ("conv1_2", 64, False),
    ("conv2_1", 128, True), ("conv2_2", 128, False),
    ("conv3_1", 256, True), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv4_1", 512, True), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, True), ("conv5_2", 512, False), ("conv5_3", 512, False),
)
LPIPS_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")

# Input normalization of the lpips package's ScalingLayer (maps [-1, 1]
# inputs to the VGG training distribution).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS_RELPATH = os.path.join("weights", "lpips_vgg.npz")

# Provenance stamp of the exporter. Metric paths refuse weights without it,
# so random test weights never reach a table as "LPIPS".
PROVENANCE_KEY = "__provenance__"
EXPORT_PROVENANCE = "lpips-vgg16-imagenet+lpips-lin-v1"


def default_weights_path() -> str:
    env = os.environ.get("ONDT_LPIPS_WEIGHTS")
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo_root, DEFAULT_WEIGHTS_RELPATH)


def load_weights(path: Optional[str] = None,
                 require_export_provenance: bool = True) -> Dict[str, np.ndarray]:
    """Load the LPIPS weights npz as float32 numpy arrays in the file's
    (HWIO) layout; raise a loud ValueError if absent, incomplete or, with
    `require_export_provenance`, unstamped. `require_export_provenance=False`
    is for tests of the machinery only; metric paths must not set it."""
    path = path or default_weights_path()
    if not os.path.isfile(path):
        raise ValueError(
            f"LPIPS weights file not found at {path!r}. LPIPS needs the "
            "VGG16+calibration weights, which are not bundled. Export them "
            "on a machine with torchvision+lpips installed:\n"
            "  python -m outdoor_nerf_depth_torch.tools.export_lpips_weights "
            "weights/lpips_vgg.npz\n"
            "or point ONDT_LPIPS_WEIGHTS at an existing file. "
            "(Refusing to silently skip LPIPS.)"
        )
    raw = np.load(path)
    provenance = str(raw[PROVENANCE_KEY]) if PROVENANCE_KEY in raw.files else None
    if require_export_provenance and provenance != EXPORT_PROVENANCE:
        raise ValueError(
            f"LPIPS weights file {path!r} lacks the exporter provenance "
            f"stamp (found {provenance!r}, need {EXPORT_PROVENANCE!r}). "
            "Only weights written by the exporter "
            "(outdoor_nerf_depth_torch.tools.export_lpips_weights) measure "
            "perceptual distance; refusing to report LPIPS from anything "
            "else (e.g. a random-weights test fixture)."
        )
    weights = {k: np.asarray(raw[k], np.float32) for k in raw.files if k != PROVENANCE_KEY}
    missing = [
        k
        for name, _, _ in VGG16_CONVS
        for k in (f"{name}/kernel", f"{name}/bias")
        if k not in weights
    ] + [f"lin{i}/weight" for i in range(len(LPIPS_TAPS)) if f"lin{i}/weight" not in weights]
    if missing:
        shown = f"{missing[:6]}..." if len(missing) > 6 else f"{missing}"
        raise ValueError(f"LPIPS weights file {path!r} is missing keys: {shown}")
    return weights


def to_torch(weights: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The npz arrays as float32 tensors on `device`, conv kernels HWIO -> OIHW."""
    out = {}
    for k, v in weights.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        if k.endswith("/kernel"):
            t = t.permute(3, 2, 0, 1)
        out[k] = t.contiguous().to(device)
    return out


def _vgg_features(weights, x):
    """x: [N, 3, H, W] in VGG-normalized space -> dict of tap activations."""
    taps = {}
    h = x
    for name, _, pool_before in VGG16_CONVS:
        if pool_before:
            h = F.max_pool2d(h, kernel_size=2, stride=2)
        h = F.relu(F.conv2d(h, weights[f"{name}/kernel"], weights[f"{name}/bias"], padding=1))
        if name in LPIPS_TAPS:
            taps[name] = h
    return taps


def _unit_normalize(f, eps=1e-10):
    return f / torch.sqrt(torch.sum(f**2, dim=1, keepdim=True) + eps)


def lpips_distance(weights, pred, target):
    """LPIPS distance between [..., H, W, 3] images in [0, 1] (tensors), with
    `weights` from `to_torch`. A scalar: the mean over a leading batch axis
    if present."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    shift = torch.tensor(_SHIFT, dtype=pred.dtype, device=pred.device)[:, None, None]
    scale = torch.tensor(_SCALE, dtype=pred.dtype, device=pred.device)[:, None, None]

    # [0,1] -> [-1,1] -> VGG space (the lpips ScalingLayer), NHWC -> NCHW.
    def norm(img):
        img = 2.0 * torch.clip(img, 0.0, 1.0) - 1.0
        return (img.permute(0, 3, 1, 2) - shift) / scale

    taps_p = _vgg_features(weights, norm(pred))
    taps_t = _vgg_features(weights, norm(target))
    total = 0.0
    for i, name in enumerate(LPIPS_TAPS):
        diff = _unit_normalize(taps_p[name]) - _unit_normalize(taps_t[name])
        w = weights[f"lin{i}/weight"][:, None, None]  # [C], non-negative
        # 1x1 conv with non-negative weights == weighted channel sum.
        total = total + torch.mean(torch.sum(w * diff**2, dim=1), dim=(-2, -1))
    return torch.mean(total)


def make_lpips_fn(path: Optional[str] = None, require_export_provenance: bool = True,
                  device=None) -> Callable:
    """Build an lpips(pred, target) -> float closure over host images.

    The weights are loaded first, so a missing or unstamped file raises
    ValueError whatever the device. It computes on `device` (None means
    CUDA, and raises without it) in float32 with TF32 off.
    """
    weights = load_weights(path, require_export_provenance)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    dev_weights = to_torch(weights, device)

    def compute(pred, target):
        with torch.inference_mode():
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
            return float(lpips_distance(dev_weights, t(pred), t(target)))

    return compute


def save_weights(path: str, weights: Dict[str, np.ndarray], provenance: str = "unstamped"):
    """Write a weights npz (for test fixtures and the export tool).

    Only the exporter passes `provenance=EXPORT_PROVENANCE`; anything else
    (including the default) is refused by provenance-checking loads.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {k: np.asarray(v, np.float32) for k, v in weights.items()}
    arrays[PROVENANCE_KEY] = np.asarray(provenance)
    np.savez(path, **arrays)


def random_weights(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """He-initialized random VGG16 + uniform lin weights, the same draws as
    the reference's `random_weights` from the same generator state.

    Not a perceptual metric: a structurally complete stand-in for tests of
    the LPIPS machinery when the real weights file is not on disk.
    """
    weights = {}
    cin = 3
    for name, cout, _ in VGG16_CONVS:
        fan_in = 3 * 3 * cin
        weights[f"{name}/kernel"] = rng.normal(
            0.0, np.sqrt(2.0 / fan_in), (3, 3, cin, cout)
        ).astype(np.float32)
        weights[f"{name}/bias"] = np.zeros((cout,), np.float32)
        cin = cout
    channels = {n: c for n, c, _ in VGG16_CONVS}
    for i, name in enumerate(LPIPS_TAPS):
        weights[f"lin{i}/weight"] = np.full((channels[name],), 1.0 / channels[name], np.float32)
    return weights
