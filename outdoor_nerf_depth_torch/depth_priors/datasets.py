"""Training data for the depth-prior nets: stereo pairs and RGB-D frames.

Port of `StereoPairDataset` and `CompletionDataset` from the reference
package's `depth_priors/datasets.py`: KITTI-style folder layouts with uint16
depth or disparity PNGs, random crops drawn from `np.random.default_rng(seed)`
in the reference's order, so a seed gives the reference's batches exactly.
Batches are float32 numpy arrays, NHWC. Images are read with the port's PNG
codec; a JPEG input raises ValueError (the port has no JPEG decoder).
`CompletionDataset.sample_batch_with_near` serves the photometric
self-supervision: each crop with its temporal neighbour and their relative
pose from the port's OpenCV-free PnP (`depth_priors/pose.py`), whose RANSAC
draws from its own generator, so the crops follow the reference's draws.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from outdoor_nerf_depth_torch.data.datasets import load_image


def _list_images(d):
    return sorted(
        f for f in os.listdir(d) if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )


class StereoPairDataset:
    """Folder-layout stereo training data.

    root/
      left/  (or image_2/)   rgb
      right/ (or image_3/)   rgb
      disp/  (or disp_occ_0/, disp_occ/) uint16 disparity PNGs, value/256 = pixels
    """

    def __init__(self, root: str, crop: Tuple[int, int] = (256, 512), seed: int = 0):
        def pick(*names):
            return next((os.path.join(root, n) for n in names
                         if os.path.isdir(os.path.join(root, n))), None)

        self.left_dir = pick("left", "image_2")
        self.right_dir = pick("right", "image_3")
        self.disp_dir = pick("disp", "disp_occ_0", "disp_occ")
        if not (self.left_dir and self.right_dir):
            raise FileNotFoundError(f"no stereo folders under {root}")
        self.files = _list_images(self.left_dir)
        self.crop = crop
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def sample_batch(self, batch_size: int):
        """Random crops: (left, right, disp) float32; disp 0 where unknown."""
        ch, cw = self.crop
        lefts, rights, disps = [], [], []
        for _ in range(batch_size):
            name = self.files[self._rng.integers(len(self.files))]
            left = load_image(os.path.join(self.left_dir, name)) / 255.0
            right = load_image(os.path.join(self.right_dir, name)) / 255.0
            if self.disp_dir and os.path.exists(os.path.join(self.disp_dir, name)):
                disp = load_image(os.path.join(self.disp_dir, name)) / 256.0
            else:
                disp = np.zeros(left.shape[:2], np.float32)
            h, w = left.shape[:2]
            y0 = self._rng.integers(0, max(1, h - ch + 1))
            x0 = self._rng.integers(0, max(1, w - cw + 1))
            sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
            lefts.append(left[sl])
            rights.append(right[sl])
            disps.append(disp[sl])
        return (
            np.stack(lefts).astype(np.float32),
            np.stack(rights).astype(np.float32),
            np.stack(disps).astype(np.float32),
        )


class CompletionDataset:
    """RGB + sparse LiDAR + (optional) dense GT, KITTI-completion layout.

    root/{image, sparse, groundtruth}/*.png; depth PNGs are uint16 / 256 m.
    """

    def __init__(self, root: str, crop: Tuple[int, int] = (256, 512), seed: int = 0):
        self.image_dir = os.path.join(root, "image")
        self.sparse_dir = os.path.join(root, "sparse")
        self.gt_dir = os.path.join(root, "groundtruth")
        if not os.path.isdir(self.image_dir):
            raise FileNotFoundError(f"no image dir under {root}")
        self.files = _list_images(self.image_dir)
        self.crop = crop
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def _frame(self, name: str):
        """(rgb, sparse, gt) of one file; gt is the sparse depth where no
        groundtruth file exists."""
        rgb = load_image(os.path.join(self.image_dir, name)) / 255.0
        sparse = load_image(os.path.join(self.sparse_dir, name)) / 256.0
        gt_path = os.path.join(self.gt_dir, name)
        gt = load_image(gt_path) / 256.0 if os.path.exists(gt_path) else sparse
        return rgb, sparse, gt

    def sample_batch(self, batch_size: int):
        """Random crops: (rgb, sparse, gt) float32."""
        ch, cw = self.crop
        rgbs, sparses, gts = [], [], []
        for _ in range(batch_size):
            rgb, sparse, gt = self._frame(self.files[self._rng.integers(len(self.files))])
            h, w = rgb.shape[:2]
            y0 = self._rng.integers(0, max(1, h - ch + 1))
            x0 = self._rng.integers(0, max(1, w - cw + 1))
            sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
            rgbs.append(rgb[sl])
            sparses.append(sparse[sl])
            gts.append(gt[sl])
        return (
            np.stack(rgbs).astype(np.float32),
            np.stack(sparses).astype(np.float32),
            np.stack(gts).astype(np.float32),
        )

    def intrinsics(self, height: int, width: int) -> np.ndarray:
        """Camera matrix for a (cropped) image: root/K.txt when present,
        else the KITTI default focal with a centred principal point."""
        k_file = os.path.join(os.path.dirname(self.image_dir), "K.txt")
        if os.path.exists(k_file):
            return np.loadtxt(k_file).reshape(3, 3).astype(np.float32)
        focal = 721.5377  # KITTI raw calibration ballpark (std2019 default).
        return np.array(
            [[focal, 0, (width - 1) / 2.0], [0, focal, (height - 1) / 2.0], [0, 0, 1.0]],
            np.float32,
        )

    def sample_batch_with_near(self, batch_size: int):
        """Batch augmented for photometric self-supervision.

        Returns (rgb, sparse, gt, rgb_near, R [B,3,3], t [B,3], success [B],
        K [3,3]): the nearby frame is the temporal neighbour (the next file,
        else the previous one), with its relative pose estimated by PnP
        against the sparse depth. Items where PnP fails get the identity
        pose and success 0 so the loss can mask them. The draws follow the
        reference's order: file index, then the crop's y0 and x0. K is
        `intrinsics` at the crop's size; a K.txt is used as it is, not
        shifted by the crop offset, as in the reference.
        """
        from outdoor_nerf_depth_torch.depth_priors import pose as pose_lib

        ch, cw = self.crop
        K = None
        rgbs, sparses, gts, nears, Rs, ts, succ = [], [], [], [], [], [], []
        for _ in range(batch_size):
            i = int(self._rng.integers(len(self.files)))
            j = i + 1 if i + 1 < len(self.files) else i - 1
            rgb, sparse, gt = self._frame(self.files[i])
            near = load_image(os.path.join(self.image_dir, self.files[max(0, j)])) / 255.0
            h, w = rgb.shape[:2]
            y0 = int(self._rng.integers(0, max(1, h - ch + 1)))
            x0 = int(self._rng.integers(0, max(1, w - cw + 1)))
            sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
            rgb, near, sparse, gt = rgb[sl], near[sl], sparse[sl], gt[sl]
            if K is None:
                # One K for the batch, at the crop's size.
                K = self.intrinsics(*rgb.shape[:2])
            ok, R, t = pose_lib.estimate_pose_pnp(rgb, near, sparse, K)
            if not ok:
                R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            rgbs.append(rgb)
            nears.append(near)
            sparses.append(sparse)
            gts.append(gt)
            Rs.append(R)
            ts.append(t)
            succ.append(1.0 if ok else 0.0)
        return (
            np.stack(rgbs).astype(np.float32),
            np.stack(sparses).astype(np.float32),
            np.stack(gts).astype(np.float32),
            np.stack(nears).astype(np.float32),
            np.stack(Rs).astype(np.float32),
            np.stack(ts).astype(np.float32),
            np.asarray(succ, np.float32),
            K.astype(np.float32),
        )
