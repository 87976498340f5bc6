"""Image output helpers.

Port of `save_depth_u16` from the reference package's `utils/image.py`,
written with the port's own PNG codec (`data/png.py`).
"""

from __future__ import annotations

import numpy as np

from outdoor_nerf_depth_torch.data import png


def save_depth_u16(depth_m, path: str):
    """Save metric depth as a KITTI-convention uint16 PNG (metres * 256).

    The codes are the reference's: NaN becomes 0, then the value times 256
    is clipped to [0, 65535] and truncated to an integer.
    """
    arr = np.clip(np.nan_to_num(np.asarray(depth_m)) * 256.0, 0, 65535).astype(np.uint16)
    png.write_png(path, arr)
