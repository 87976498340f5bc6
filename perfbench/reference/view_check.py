"""The output check of a viewing cell: the set-up's training, redone by the
plain reference from the seed, and a sample of the window's views,
rendered again by it from the state the program handed its viewer.

Training: the reference trains its own model and occupancy grid from the
seed on the program's set-up batches (`train_check.follow`: its own
initial parameters, jitter and refreshes), the batches being checked on
their own against the written scene (`reference/data.py`); the numbers
are `train_check`'s, with `refresh_grid_gap` taken on the grid the viewer
renders with.

Views: after 256 steps the two trained models differ by round-off grown
through training as far as a TF32 reference does (PERF.md), so the views
are rendered again from the program's handed weights and grid. The
reference casts each sampled view's rays itself (a frozen copy of the
viewer's orbit pose and pinhole of focal 1.1 x width, cast on the host in
float32) and renders them with the dense renderer in the same chunks (each
chunk plans its own sample budget):

- `view_rgb_gap`: largest |difference| of a pixel's colour channel.
- `view_depth_gap`: largest |difference| of a pixel's depth, over the
  largest reference depth of its view.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import data as data_ref
from perfbench.reference import ngp as ngp_ref
from perfbench.reference import train_check

OPENCV_TO_OPENGL3 = np.diag([1.0, -1.0, -1.0])


def orbit_pose(center, radius, theta, phi) -> np.ndarray:
    """OpenGL camera-to-world [3, 4] of an orbit camera looking at `center`."""
    center = np.asarray(center, np.float64)
    pos = center + radius * np.array([np.cos(phi) * np.sin(theta),
                                      np.cos(phi) * np.cos(theta), np.sin(phi)])
    norm = lambda v: v / np.linalg.norm(v)
    z = norm(pos - center)
    x = norm(np.cross(np.array([0.0, 0.0, 1.0]), z))
    y = norm(np.cross(z, x))
    return np.stack([x, y, z, pos], axis=1)


def view_rays(orbit, h: int, w: int, near: float, far: float) -> dict:
    """The view's rays on the host: origins and unit view directions [h, w, 3]."""
    focal = 1.1 * w
    k = np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1.0]])
    pixtocam = torch.from_numpy(np.linalg.inv(k).astype(np.float32))
    c2w = torch.from_numpy(orbit_pose(*orbit).astype(np.float32))
    px, py = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    px = torch.from_numpy(px.astype(np.float32))
    py = torch.from_numpy(py.astype(np.float32))
    pix = torch.stack([px + 0.5, py + 0.5, torch.ones_like(px)], dim=-1)
    cam = (pixtocam @ pix[..., None])[..., 0] @ torch.as_tensor(OPENCV_TO_OPENGL3,
                                                                 dtype=torch.float32)
    d = (c2w[:3, :3] @ cam[..., None])[..., 0]
    return {"origins": torch.broadcast_to(c2w[:3, -1], d.shape),
            "viewdirs": d / torch.linalg.norm(d, dim=-1, keepdim=True),
            "near": torch.full((h, w, 1), near), "far": torch.full((h, w, 1), far)}


@torch.no_grad()
def render_view(params, shapes, grid, rays: dict, chunk: int, device: str):
    h, w = rays["origins"].shape[:2]
    flat = {k: v.reshape(h * w, -1) for k, v in rays.items()}
    rgb, depth = [], []
    for start in range(0, h * w, chunk):
        part = {k: v[start:start + chunk].to(device) for k, v in flat.items()}
        out, _ = ngp_ref.render(params, shapes, part, grid, None)
        rgb.append(out["rgb"].cpu())
        depth.append(out["depth"].cpu())
    return torch.cat(rgb).reshape(h, w, 3).numpy(), torch.cat(depth).reshape(h, w).numpy()


def gaps(outputs, refs) -> dict:
    rgb = max(float(np.abs(o[0] - r[0]).max()) for o, r in zip(outputs, refs))
    depth = max(float(np.abs(o[1] - r[1]).max() / max(np.abs(r[1]).max(), 1e-12))
                for o, r in zip(outputs, refs))
    return {"view_rgb_gap": rgb, "view_depth_gap": depth}


def check(cfg: dict, seed: int, scene_params: dict, scene_dir: str, steps, state: dict, sample,
          size, near_far, chunk: int, device: str, limits: dict, control: bool = False) -> dict:
    """{number: (reading, limit)} of the set-up's followed steps (`steps`:
    the driver's FirstSteps) and of the sampled views (`sample`: [(orbit,
    (rgb, depth))]), rendered again from the state handed to the viewer
    (`state`: the model's state dict on the CPU). With `control`, also the
    reference trained and rendering in TF32, under `control.<number>`, and
    trained with half of each batch left out, under
    `fault.half_batch.<number>`."""
    scene = data_ref.Scene(scene_dir, scene_params)
    rays_off = sum(data_ref.batch_errors(scene, b) for b in steps.batches)
    ref = train_check.follow(cfg, seed, steps.batches, device)
    del ref["model"]
    handed = {k: v for k, v in state.items() if k != "occupancy"}
    numbers = train_check.compare(
        dict(train_check.program_readings(steps), grid_last=state["occupancy"]), ref)

    shapes = ngp_ref.Shapes(cfg["model_params"])
    params = {k: v.to(device) for k, v in handed.items()}
    grid = state["occupancy"].to(device)
    h, w = size
    rays = [view_rays(orbit, h, w, *near_far) for orbit, _ in sample]
    with train_check.matmul_precision(False):
        refs = [render_view(params, shapes, grid, r, chunk, device) for r in rays]
    numbers.update(gaps([o for _, o in sample], refs))
    out = {"batch_rays_off": (float(rays_off), 0.0)}
    out.update({k: (v, limits.get(k, 0.0)) for k, v in numbers.items()})
    if control:
        others = {"control": train_check.follow(cfg, seed, steps.batches, device, tf32=True),
                  "fault.half_batch": train_check.follow(
                      cfg, seed, train_check.half_batches(steps.batches), device)}
        for name, run in others.items():
            del run["model"]
            out.update({f"{name}.{k}": (v, limits.get(k, 0.0))
                        for k, v in train_check.compare(run, ref).items()})
        with train_check.matmul_precision(True):
            low = [render_view(params, shapes, grid, r, chunk, device) for r in rays]
        out.update({f"control.{k}": (v, limits.get(k, 0.0)) for k, v in gaps(low, refs).items()})
    return out
