"""Export LPIPS(VGG) weights to the npz contract of `train/lpips.py`.

    python -m outdoor_nerf_depth_torch.tools.export_lpips_weights weights/lpips_vgg.npz

The port's counterpart of the repository's `tools/export_lpips_weights.py`.
It runs where torchvision (with its VGG16 ImageNet weights) and the `lpips`
package are installed; it needs nothing else of the repository than the
port. Keys, all float32:

  conv{b}_{i}/kernel  [3, 3, cin, cout]   HWIO (transposed from torch OIHW)
  conv{b}_{i}/bias    [cout]
  lin{k}/weight       [C_k]               the non-negative 1x1 calibration
                                          weights of taps relu1_2, 2_2,
                                          3_3, 4_3, 5_3

Sources: torchvision `vgg16(weights=IMAGENET1K_V1).features` for the
convolutions, `lpips.LPIPS(net='vgg').lins[k].model[-1].weight` for the
calibration. The file carries `EXPORT_PROVENANCE`, which the metric
requires.
"""

from __future__ import annotations

import sys

import numpy as np

from outdoor_nerf_depth_torch.train.lpips import EXPORT_PROVENANCE, VGG16_CONVS, save_weights


def main(out_path: str = "weights/lpips_vgg.npz"):
    import lpips as lpips_pkg
    import torchvision

    vgg = torchvision.models.vgg16(
        weights=torchvision.models.VGG16_Weights.IMAGENET1K_V1
    ).features
    convs = [m for m in vgg if m.__class__.__name__ == "Conv2d"]
    if len(convs) != len(VGG16_CONVS):
        raise ValueError(f"torchvision's VGG16 has {len(convs)} convolutions, "
                         f"expected {len(VGG16_CONVS)}")
    weights = {}
    for (name, cout, _), conv in zip(VGG16_CONVS, convs):
        w = conv.weight.detach().cpu().numpy()  # [cout, cin, kh, kw]
        if w.shape[0] != cout:
            raise ValueError(f"{name}: {w.shape[0]} output channels, expected {cout}")
        weights[f"{name}/kernel"] = np.transpose(w, (2, 3, 1, 0))
        weights[f"{name}/bias"] = conv.bias.detach().cpu().numpy()

    net = lpips_pkg.LPIPS(net="vgg")
    for k, lin in enumerate(net.lins):
        w = lin.model[-1].weight.detach().cpu().numpy()  # [1, C, 1, 1]
        weights[f"lin{k}/weight"] = np.clip(w[0, :, 0, 0], 0.0, None)

    save_weights(out_path, weights, provenance=EXPORT_PROVENANCE)
    print(f"wrote {out_path} ({len(weights)} arrays, provenance-stamped)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
