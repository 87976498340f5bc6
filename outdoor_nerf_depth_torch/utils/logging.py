"""Metric writer: JSONL always, TensorBoard events when available.

Port of the reference package's `utils/logging.py`. Every scalar lands in
`log_dir/metrics.jsonl`; torch's TensorBoard `SummaryWriter` gets them too
when `torch.utils.tensorboard` imports (it needs the tensorboard package,
which is optional), and only then do images and histograms go anywhere
unless an `out_dir` is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional

import numpy as np

from outdoor_nerf_depth_torch.utils import image as image_lib


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def scalars(self, step: int, values: Mapping[str, float], prefix: str = ""):
        flat = {
            (f"{prefix}/{k}" if prefix else k): float(v)
            for k, v in values.items()
            if np.isscalar(v) or getattr(v, "ndim", 1) == 0
        }
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **flat}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def image(self, step: int, tag: str, img, out_dir: Optional[str] = None):
        """Log an [H, W, 3] float image (TB and/or a PNG in `out_dir`)."""
        img = np.clip(np.nan_to_num(np.asarray(img)), 0.0, 1.0)
        if self._tb is not None:
            self._tb.add_image(tag, img.transpose(2, 0, 1), step)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            image_lib.save_img_u8(img, os.path.join(out_dir, f"{tag}_{step:06d}.png"))

    def histogram(self, step: int, tag: str, values):
        if self._tb is not None:
            self._tb.add_histogram(tag, np.asarray(values), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
