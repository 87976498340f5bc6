"""The output check of the NeRF++ training cell: the reference follows the
program's first train steps and the numbers of the two are compared.

The port's NeRF++ reader gives each camera its own intrinsics, so the loop
draws its batches as pixels and casts them inside the train step. The check
takes the pixels of each followed batch, checks the batch against the
written NeRF++ layout (`Scene`, `batch_errors`), and casts, colours and
bounds those pixels from the layout itself for the reference's steps. The
reference (`reference/nerfpp.py`) draws its own initial parameters from the
seed and its own jitter and resampling draws from a card generator seeded
alike, clips each level's gradients by their norm and steps Adam as
torch.optim.Adam's multi-tensor path evaluates it (`adam_step`). Numbers,
each with the limit the configuration file sets under `limits`, as
`reference/train_check.py:compare` reads them:

- `batch_rays_off`: rays of the followed batches whose pixel, camera,
  colour, depths, near or far bound, or loss weight is not the layout's
  (exact: 0).
- `init_gap`: largest |difference| of an initial parameter (exact: 0).
- `loss_gap`, `grad_gap`, `change_gap`: the losses of steps 0 to 2, the
  step-0 gradients the optimizer got and the parameters' change over the
  three steps.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import scene as scene_lib
from perfbench.reference import nerfpp as nerfpp_ref
from perfbench.reference import train_check

OPENCV_TO_OPENGL3 = np.diag([1.0, -1.0, -1.0])
FAR = 2.0  # the unit-sphere scene's far bound: past the sphere exit of every ray
MAX_DEPTH = 100.0  # what a min-depth code of 255 stands for where no max_depth.txt is written
NEAR_PAD = 1e-4  # added to every min-depth value


class Scene:
    """The train split of the NeRF++ layout as the reference reads it."""

    def __init__(self, scene_dir: str):
        self.dir = os.path.join(scene_dir, "train")
        self.stems = sorted(os.path.splitext(n)[0]
                            for n in os.listdir(os.path.join(self.dir, "rgb")))
        mats = lambda sub: np.stack([
            np.loadtxt(os.path.join(self.dir, sub, s + ".txt")).reshape(4, 4) for s in self.stems])
        pose, k = mats("pose"), mats("intrinsics")
        self.c2w = np.concatenate([pose[:, :3, :3] @ OPENCV_TO_OPENGL3, pose[:, :3, 3:]],
                                  -1).astype(np.float32)
        self.pixtocam = np.linalg.inv(k[:, :3, :3]).astype(np.float32)
        with open(os.path.join(scene_dir, "scale")) as f:
            self.scale = float(f.read().split()[0])
        self._cache = {}

    def _png(self, sub: str, cam: int) -> np.ndarray:
        key = (sub, cam)
        if key not in self._cache:
            path = os.path.join(self.dir, sub, self.stems[cam] + ".png")
            code = scene_lib.decode_png(path)  # a grey 8-bit map as [H, W, 1]
            code = code[..., 0] if code.shape[-1:] == (1,) else code
            self._cache[key] = code.astype(np.float32)
        return self._cache[key]

    def rgb(self, cam: int):
        return self._png("rgb", cam) / 255.0

    def depth(self, cam: int):
        d = self._png("depth", cam) / 256.0 * self.scale
        d[d <= 0] = -1.0
        return d

    def near(self, cam: int):
        return self._png("min_depth", cam) / 255.0 * MAX_DEPTH + NEAR_PAD

    def pixels(self, batch: dict):
        """(camera, x, y) of each ray as integer arrays."""
        return (batch["cam_idx"].numpy().reshape(-1).astype(np.int64),
                batch["pix_x"].numpy().astype(np.int64), batch["pix_y"].numpy().astype(np.int64))

    def gather(self, batch: dict) -> dict:
        """The layout's rgb [n, 3], depth [n] and near [n] at each ray's pixel."""
        cam, px, py = self.pixels(batch)
        out = {"rgb": np.zeros((len(cam), 3), np.float32), "depth": np.zeros(len(cam), np.float32),
               "near": np.zeros(len(cam), np.float32)}
        for c in np.unique(cam):
            at = cam == c
            for name in out:
                out[name][at] = getattr(self, name)(c)[py[at], px[at]]
        return out


def batch_errors(scene: Scene, batch: dict) -> int:
    """How many of the batch's rays are not the layout's pixels, colours, depths and bounds."""
    cam = batch["cam_idx"].numpy().reshape(-1)
    x, y = batch["pix_x"].numpy(), batch["pix_y"].numpy()
    n = len(cam)
    h, w = scene.rgb(0).shape[:2]
    bad = (x != np.round(x)) | (y != np.round(y)) | (x < 0) | (x >= w) | (y < 0) | (y >= h)
    bad |= (cam < 0) | (cam >= len(scene.stems)) | (cam != np.round(cam))
    if bad.any():
        return n
    ref = scene.gather(batch)
    bad |= np.any(batch["rgb"].numpy() != ref["rgb"], axis=-1)
    bad |= batch["depth_gt"].numpy() != ref["depth"]
    bad |= batch["depth_sup"].numpy() != ref["depth"]
    bad |= batch["near"].numpy().reshape(-1) != ref["near"]
    bad |= batch["far"].numpy().reshape(-1) != np.float32(FAR)
    bad |= batch["lossmult"].numpy().reshape(-1) != 1.0
    return int(bad.sum())


def reference_batch(scene: Scene, batch: dict, device: str) -> dict:
    """The reference's input at the batch's pixels: pinhole rays through the
    pixel centres, cast on `device`, and the layout's colours, depths and bounds."""
    cam, px, py = scene.pixels(batch)
    data = scene.gather(batch)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    pix = torch.stack([put(px.astype(np.float32)) + 0.5, put(py.astype(np.float32)) + 0.5,
                       torch.ones(len(cam), device=device)], dim=-1)
    flip = torch.tensor([1.0, -1.0, -1.0], device=device)
    cam_dirs = torch.einsum("nij,nj->ni", put(scene.pixtocam[cam]), pix) * flip
    c2w = put(scene.c2w[cam])
    return {"origins": c2w[:, :3, 3], "directions": torch.einsum("nij,nj->ni", c2w[:, :3, :3],
                                                                  cam_dirs),
            "near": put(data["near"])[:, None], "rgb": put(data["rgb"]),
            "lossmult": torch.ones(len(cam), 1, device=device), "depth_sup": put(data["depth"])}


def adam_step(params, grads, m, v, i: int, lr: float, b1: float, b2: float, eps: float):
    """Step i of Adam on lists of tensors, each operation as torch.optim.Adam's
    multi-tensor path evaluates it (the first moment by lerp), so where the
    program's steps are reproducible the followed steps agree to the bit."""
    c1, c2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
    torch._foreach_lerp_(m, grads, 1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, 1.0 - b2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_div_(denom, [c2 ** 0.5] * len(v))
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, m, denom, [(lr / c1) * -1] * len(params))


def follow(cfg: dict, seed: int, scene: Scene, batches, device: str, tf32: bool = False) -> dict:
    """Run the reference through the followed steps at the batches' pixels,
    from its own initial parameters and its own draws. Returns (on the CPU)
    the initial parameters, each step's loss, the step-0 gradients after
    clipping, and the parameters after `CHANGE_STEPS` steps."""
    mp = cfg["model_params"]
    init = nerfpp_ref.init_params(mp, seed)
    params = {k: v.to(device, copy=True).requires_grad_(True) for k, v in init.items()}
    names = list(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"init": init, "losses": [], "grid0": None}
    b1, b2, eps = cfg["adam_beta1"], cfg["adam_beta2"], cfg["adam_eps"]
    m = [torch.zeros_like(p) for p in params.values()]
    v = [torch.zeros_like(p) for p in params.values()]
    max_norm = cfg["grad_max_norm"]
    with train_check.matmul_precision(tf32):
        for i, batch in enumerate(batches):
            b = reference_batch(scene, batch, device)
            total = nerfpp_ref.loss(cfg, b, nerfpp_ref.render(params, mp, b, gen))
            grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names])))
            out["losses"].append(float(total.detach()))
            with torch.no_grad():
                if max_norm > 0:
                    for group in nerfpp_ref.groups(params).values():
                        norm = torch.sqrt(sum(torch.sum(grads[k] ** 2) for k in group))
                        mult = torch.clamp(max_norm / (1e-12 + norm), max=1.0)
                        for k in group:
                            grads[k] = grads[k] * mult
                grads = {k: torch.nan_to_num(g) for k, g in grads.items()}
                if i == 0:
                    out["grads0"] = {k: g.cpu() for k, g in grads.items()}
                adam_step(list(params.values()), [grads[k] for k in names], m, v, i,
                          train_check.lr_at(cfg, i), b1, b2, eps)
                if i == min(len(batches), train_check.CHANGE_STEPS) - 1:
                    out["after"] = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
            del grads
    return out


def check(cfg: dict, seed: int, scene_dir: str, steps, device: str, limits: dict,
          control: bool = False) -> dict:
    """{number: (reading, limit)} of the program's followed steps. With
    `control`, also each number of the reference in the program's place
    computed one precision down (TF32), under `control.<number>`, and with
    half of each batch left out, under `fault.half_batch.<number>`."""
    scene = Scene(scene_dir)
    rays_off = sum(batch_errors(scene, b) for b in steps.batches)
    ref = follow(cfg, seed, scene, steps.batches, device)
    numbers = train_check.compare(train_check.program_readings(steps), ref)
    out = {"batch_rays_off": (float(rays_off), 0.0)}
    out.update({k: (v, limits.get(k, 0.0)) for k, v in numbers.items()})
    if control:
        others = {"control": follow(cfg, seed, scene, steps.batches, device, tf32=True),
                  "fault.half_batch": follow(cfg, seed, scene,
                                             train_check.half_batches(steps.batches), device)}
        for name, run in others.items():
            out.update({f"{name}.{k}": (v, limits.get(k, 0.0))
                        for k, v in train_check.compare(run, ref).items()})
    return out
