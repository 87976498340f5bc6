"""Stereo benchmark datasets: SceneFlow / KITTI-2012 / KITTI-2015 /
Middlebury / ETH3D ingestion for training the stereo depth priors.

Port of the reference package's `depth_priors/benchmark_data.py` (numpy
only; images through the port's PNG codec, so JPEG inputs raise):

* PFM reading and writing (`read_pfm`, `write_pfm`) and `load_disparity`
  for both disparity codecs (PFM, or uint16 PNG / 256);
* reference-format list files (`left right [disp]` rows), read and written,
  and the directory scanners of the five benchmarks (`SCANNERS`);
* `StereoBenchmarkDataset`, one parameterised dataset with static-shape
  batches: train crops with the reference recipe's augmentation
  (asymmetric per-eye brightness U[0.5, 2), gamma U[0.8, 1.2), contrast
  U[0.8, 1.2), random crop, a mean-filled occlusion patch on the right eye,
  ImageNet-statistics normalisation), drawn from one seeded
  `np.random.Generator` in the reference's order; eval batches in each
  benchmark's canonical shape (KITTI padded to 384x1248, SceneFlow cropped
  to 512x960);
* `disparity_metrics`: EPE and D1.

Disparity is in pixels at full resolution; 0 or +inf means unknown (KITTI
uses 0, Middlebury PFMs use inf; both are masked).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from outdoor_nerf_depth_torch.data.datasets import load_image

# The reference normalizes both eyes with torchvision's ImageNet statistics
# (`data_io.py:6-13`); the nets only care that train and inference agree.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Canonical eval shapes (reference `kitti_dataset.py:132-143` pads KITTI to
# 384x1248 top/right; `sceneflow_dataset.py:119-124` crops SceneFlow to the
# bottom-right 512x960).
KITTI_EVAL_SHAPE = (384, 1248)
SCENEFLOW_EVAL_SHAPE = (512, 960)


# ---------------------------------------------------------------------------
# PFM IO (SceneFlow / Middlebury / ETH3D disparity codec).


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Read a PFM file -> (float32 array [H,W] or [H,W,3], scale).

    PFM stores rows bottom-to-top; the sign of the scale line encodes
    endianness (negative = little-endian). Matches the reference reader
    (`readpfm.py:6-50`) including the vertical flip.
    """
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("ascii")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("ascii").strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.fromfile(f, dtype, count=width * height * channels)
    if data.size != width * height * channels:
        raise ValueError(f"{path}: truncated PFM payload")
    shape = (height, width, 3) if channels == 3 else (height, width)
    out = np.flipud(data.reshape(shape)).astype(np.float32)
    return np.ascontiguousarray(out), abs(scale)


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    """Write a little-endian PFM (fixture/test counterpart of `read_pfm`)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        header = b"Pf"
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"PFM needs [H,W] or [H,W,3], got {data.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode("ascii"))
        f.write(f"{-abs(scale)}\n".encode("ascii"))  # negative = little-endian
        np.flipud(data).astype("<f4").tofile(f)


def load_disparity(path: str) -> np.ndarray:
    """Disparity in pixels from either codec: PFM, or uint16 PNG / 256."""
    if path.endswith(".pfm"):
        disp, _ = read_pfm(path)
        if disp.ndim == 3:
            disp = disp[..., 0]
        return disp
    img = load_image(path)
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32) / 256.0


# ---------------------------------------------------------------------------
# Filename lists: ingestion + generation.


def read_list_file(path: str) -> List[Tuple[str, str, Optional[str]]]:
    """Parse a reference-format list: `left right [disp]` per line."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) == 2:
                rows.append((parts[0], parts[1], None))
            elif len(parts) == 3:
                rows.append((parts[0], parts[1], parts[2]))
            else:
                raise ValueError(
                    f"{path}: expected 2 or 3 columns, got {len(parts)}"
                )
    if not rows:
        raise ValueError(f"{path}: empty filename list")
    return rows


def write_list_file(path: str, rows: Sequence[Tuple[str, str, Optional[str]]]):
    with open(path, "w") as f:
        for left, right, disp in rows:
            f.write(" ".join((left, right) + ((disp,) if disp else ())) + "\n")


def _rel_images(root: str, sub: str) -> List[str]:
    d = os.path.join(root, sub)
    if not os.path.isdir(d):
        return []
    return sorted(
        os.path.join(sub, n) for n in os.listdir(d)
        if n.lower().endswith((".png", ".jpg", ".jpeg"))
    )


def scan_kitti2015(root: str, split: str = "training"):
    """KITTI-2015 layout: {split}/image_2, image_3, disp_occ_0 (train only)."""
    lefts = _rel_images(root, os.path.join(split, "image_2"))
    rows = []
    for left in lefts:
        name = os.path.basename(left)
        right = os.path.join(split, "image_3", name)
        disp = os.path.join(split, "disp_occ_0", name)
        rows.append(
            (left, right, disp if os.path.isfile(os.path.join(root, disp)) else None)
        )
    return rows


def scan_kitti2012(root: str, split: str = "training"):
    """KITTI-2012 layout: {split}/colored_0, colored_1, disp_occ."""
    lefts = _rel_images(root, os.path.join(split, "colored_0"))
    rows = []
    for left in lefts:
        name = os.path.basename(left)
        right = os.path.join(split, "colored_1", name)
        disp = os.path.join(split, "disp_occ", name)
        rows.append(
            (left, right, disp if os.path.isfile(os.path.join(root, disp)) else None)
        )
    return rows


def scan_sceneflow(root: str, split: str = "TRAIN"):
    """SceneFlow layout: frames_finalpass/{split}/<letter>/<seq>/{left,right}
    + disparity/{split}/<letter>/<seq>/left/*.pfm."""
    base = os.path.join("frames_finalpass", split)
    rows = []
    for dirpath, _, files in sorted(os.walk(os.path.join(root, base))):
        if os.path.basename(dirpath) != "left":
            continue
        rel_left_dir = os.path.relpath(dirpath, root)
        for name in sorted(files):
            if not name.endswith(".png"):
                continue
            left = os.path.join(rel_left_dir, name)
            right = left.replace(os.sep + "left" + os.sep,
                                 os.sep + "right" + os.sep)
            disp = os.path.join(
                "disparity",
                os.path.relpath(dirpath, os.path.join(root, "frames_finalpass")),
                name[:-4] + ".pfm",
            )
            rows.append((left, right, disp))
    return rows


def scan_pair_dirs(root: str, left_name="im0.png", right_name="im1.png",
                   disp_name="disp0GT.pfm"):
    """Middlebury/ETH3D layout: one directory per scene holding im0/im1 +
    a GT PFM (`MiddleburyLoader.py` / `eth3dLoader.py` file contract)."""
    rows = []
    for scene in sorted(os.listdir(root)):
        d = os.path.join(root, scene)
        if not os.path.isdir(d) or not os.path.isfile(os.path.join(d, left_name)):
            continue
        disp = os.path.join(scene, disp_name)
        rows.append((
            os.path.join(scene, left_name),
            os.path.join(scene, right_name),
            disp if os.path.isfile(os.path.join(root, disp)) else None,
        ))
    return rows


SCANNERS = {
    "kitti2015": scan_kitti2015,
    "kitti2012": scan_kitti2012,
    "sceneflow": scan_sceneflow,
    "middlebury": scan_pair_dirs,
    "eth3d": scan_pair_dirs,
}


# ---------------------------------------------------------------------------
# Augmentation (train recipe of `sceneflow_dataset.py:52-111` /
# `kitti_dataset.py:63-119`, deterministic generator instead of global
# np.random).


def _photometric(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Asymmetric per-eye jitter on a [0,1] image."""
    img = img * rng.uniform(0.5, 2.0)  # brightness
    img = np.clip(img, 0.0, 1.0) ** rng.uniform(0.8, 1.2)  # gamma
    mean = img.mean()
    img = (img - mean) * rng.uniform(0.8, 1.2) + mean  # contrast
    return np.clip(img, 0.0, 1.0)


def _occlude_right(right: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Mean-fill a random patch of the right eye (occlusion robustness)."""
    h, w = right.shape[:2]
    sy = int(rng.uniform(25, 75))
    sx = int(rng.uniform(35, 100))
    sx, sy = min(sx, max(1, h // 2 - 1)), min(sy, max(1, w // 2 - 1))
    cx = int(rng.uniform(sx, h - sx))
    cy = int(rng.uniform(sy, w - sy))
    right = right.copy()
    right[cx - sx:cx + sx, cy - sy:cy + sy] = right.mean((0, 1))
    return right


def normalize(img: np.ndarray) -> np.ndarray:
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class StereoBenchmarkDataset:
    """List-file-driven stereo benchmark data with static-shape batches.

    `rows` come from `read_list_file` or a `scan_*` helper; paths are
    relative to `root`. `variant` picks the eval shaping + occlusion
    probability ("kitti" or "sceneflow"; default inferred from the
    disparity extension).
    """

    def __init__(
        self,
        root: str,
        rows: Sequence[Tuple[str, str, Optional[str]]],
        crop: Tuple[int, int] = (256, 512),
        variant: Optional[str] = None,
        augment: bool = True,
        seed: int = 0,
    ):
        if not rows:
            raise ValueError("empty stereo benchmark row list")
        self.root = root
        self.rows = list(rows)
        self.crop = tuple(crop)
        if variant is None:
            first_disp = next((d for _, _, d in self.rows if d), "")
            variant = "sceneflow" if first_disp.endswith(".pfm") else "kitti"
        if variant not in ("kitti", "sceneflow"):
            raise ValueError(f"unknown stereo benchmark variant {variant!r}")
        self.variant = variant
        self.occlusion_prob = 0.5 if variant == "sceneflow" else 0.2
        self.augment = augment
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_list_file(cls, root: str, list_file: str, **kw):
        return cls(root, read_list_file(list_file), **kw)

    @classmethod
    def from_scan(cls, root: str, benchmark: str, **kw):
        scan_kw = {}
        if "split" in kw:
            scan_kw["split"] = kw.pop("split")
        rows = SCANNERS[benchmark](root, **scan_kw)
        variant = "sceneflow" if benchmark in ("sceneflow", "middlebury",
                                               "eth3d") else "kitti"
        kw.setdefault("variant", variant)
        return cls(root, rows, **kw)

    def __len__(self):
        return len(self.rows)

    def _load(self, index: int):
        left_f, right_f, disp_f = self.rows[index]
        left = load_image(os.path.join(self.root, left_f)) / 255.0
        right = load_image(os.path.join(self.root, right_f)) / 255.0
        if disp_f is None:
            disp = np.zeros(left.shape[:2], np.float32)
        else:
            disp = load_disparity(os.path.join(self.root, disp_f))
        # inf = unknown in Middlebury GT PFMs; fold into the 0-mask.
        disp = np.where(np.isfinite(disp), disp, 0.0).astype(np.float32)
        return left.astype(np.float32), right.astype(np.float32), disp

    def sample_batch(self, batch_size: int):
        """Random augmented crops -> (left, right, disp), all [B, th, tw, .].

        Matches `StereoPairDataset.sample_batch`'s contract so
        `train_prior.py` drives either dataset unchanged; disparity is 0
        where unknown.
        """
        th, tw = self.crop
        lefts, rights, disps = [], [], []
        for _ in range(batch_size):
            left, right, disp = self._load(
                int(self._rng.integers(len(self.rows)))
            )
            if self.augment:
                left = _photometric(left, self._rng)
                right = _photometric(right, self._rng)
            h, w = left.shape[:2]
            y0 = int(self._rng.integers(0, max(1, h - th + 1)))
            x0 = int(self._rng.integers(0, max(1, w - tw + 1)))
            sl = np.s_[y0:y0 + th, x0:x0 + tw]
            left, right, disp = left[sl], right[sl], disp[sl]
            if self.augment and self._rng.uniform() < self.occlusion_prob:
                right = _occlude_right(right, self._rng)
            lefts.append(normalize(left))
            rights.append(normalize(right))
            disps.append(disp)
        return (
            np.stack(lefts).astype(np.float32),
            np.stack(rights).astype(np.float32),
            np.stack(disps).astype(np.float32),
        )

    def eval_batch(self, index: int):
        """One full image shaped to the benchmark's canonical eval geometry.

        KITTI: zero-pad top/right to 384x1248 (`kitti_dataset.py:132-143`);
        SceneFlow family: bottom-right crop to 512x960
        (`sceneflow_dataset.py:119-124`). Returns a dict with `valid` so
        metrics ignore padding and unknown disparity.
        """
        left, right, disp = self._load(index)
        h, w = left.shape[:2]
        if self.variant == "kitti":
            eh, ew = KITTI_EVAL_SHAPE
            eh, ew = max(eh, h), max(ew, w)
            top, rpad = eh - h, ew - w
            pad3 = ((top, 0), (0, rpad), (0, 0))
            left = np.pad(left, pad3)
            right = np.pad(right, pad3)
            disp = np.pad(disp, ((top, 0), (0, rpad)))
            valid = np.zeros((eh, ew), bool)
            valid[top:, : w] = True
            pads = {"top_pad": top, "right_pad": rpad}
        else:
            eh, ew = SCENEFLOW_EVAL_SHAPE
            eh, ew = min(eh, h), min(ew, w)
            left = left[h - eh:, w - ew:]
            right = right[h - eh:, w - ew:]
            disp = disp[h - eh:, w - ew:]
            valid = np.ones((eh, ew), bool)
            pads = {"top_pad": 0, "right_pad": 0}
        return {
            "left": normalize(left)[None].astype(np.float32),
            "right": normalize(right)[None].astype(np.float32),
            "disparity": disp[None].astype(np.float32),
            "valid": (valid & (disp > 0))[None],
            **pads,
        }


def disparity_metrics(pred: np.ndarray, gt: np.ndarray, valid: np.ndarray,
                      max_disp: float = 192.0):
    """EPE + D1 (the benchmark's headline numbers: >3 px AND >5% rel)."""
    m = np.asarray(valid) & (gt < max_disp)
    if not m.any():
        return {"epe": 0.0, "d1": 0.0, "n_valid": 0}
    err = np.abs(np.asarray(pred)[m] - np.asarray(gt)[m])
    bad = (err > 3.0) & (err > 0.05 * gt[m])
    return {
        "epe": float(err.mean()),
        "d1": float(bad.mean()),
        "n_valid": int(m.sum()),
    }
