"""The output check of a training cell: the reference follows the program's
train steps and the numbers of the two are compared.

The reference draws its own initial parameters from the seed and its own
random draws from a card generator seeded alike (the loop's jitter and an
NGP model's refreshes, a sweep of every cell during the warm-up and
sampled cells after it), and takes the program's train batches as its
input; the batches themselves are checked on their own against the written
scene (`reference/data.py`). Numbers, each with the limit the
configuration file sets under `limits`:

- `init_gap`: largest |difference| of an initial parameter (exact: 0).
- `batch_rays_off`: rays of the followed batches that are not the scene's (exact: 0).
- `grid_gap` (NGP): largest |difference| of the occupancy grid before step
  0, over the grid's largest value.
- `loss_gap`: largest relative gap of the loss of steps 0 to 2.
- `grad_gap`: of the gradients the optimizer got at step 0, the largest gap
  between a leaf's norm and the reference's, over the larger of that
  reference norm and the median leaf's.
- `change_gap`: the same for the parameters' change over steps 0 to 2,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone).

Past step 2 (NGP, followed through its first sampled refresh):

- `late_loss_gap`: largest relative gap of a later step's loss.
- `refresh_grid_gap`: the grid the last followed step marched on, the sum
  of |differences| over the reference's sum.
- `stage_grid_gap`, `stage_grad_gap`: the last step's refresh and step
  redone by the reference from the program's own state (`_stage`): the
  refreshed grid as `grid_gap`, the gradients as `grad_gap`. The two
  independently trained models drift apart through training as far as the
  control does, so only this stage can judge the sampled refresh and a
  step on a trained grid closely.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

from perfbench.reference import data as data_ref
from perfbench.reference import mip as mip_ref
from perfbench.reference import ngp as ngp_ref

CHANGE_STEPS = 3  # the parameters' change is compared after this many steps


def lr_at(cfg: dict, step: int) -> float:
    warm = cfg.get("lr_delay_steps", 512)
    mult = cfg.get("lr_delay_mult", 0.01)
    scale = 1.0
    if warm > 0:
        ease = math.sin(0.5 * math.pi * min(max(step / warm, 0.0), 1.0))
        scale = mult + (1.0 - mult) * ease
    lo, hi = math.log(cfg.get("lr_init", 2e-3)), math.log(cfg.get("lr_final", 2e-5))
    t = min(max(step / cfg.get("max_steps", 75000), 0.0), 1.0)
    return scale * math.exp(lo + t * (hi - lo))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matmuls in full precision, or (for the control) in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _ngp_step(cfg, params, shapes, batch, grid, gen, names):
    """One NGP forward and backward: (loss, {name: gradient})."""
    rendering, history = ngp_ref.render(params, shapes, batch, grid, gen)
    total = ngp_ref.loss(cfg, batch, rendering, history)
    grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
    return total, {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}


def _stage(cfg, shapes, batch, gen, names, stage: dict, n_cells: int, device: str) -> dict:
    """The last followed step's refresh and step again from the program's
    own state (`stage`: its parameters before that step, its grid before
    the refresh and after it), on a copy of the reference's generator at
    that point, which has made the same draws as the program's."""
    gen = torch.Generator(device=device).set_state(gen.get_state())
    params = {k: stage["params"][k].to(device, copy=True).requires_grad_(True) for k in names}
    grid = stage["grid_prev"].to(device)
    if n_cells is not None:
        grid = ngp_ref.refresh(params, shapes, grid, gen, cfg.get("occupancy_decay", 0.95),
                               n_cells)
    total, grads = _ngp_step(cfg, params, shapes, batch, stage["grid_last"].to(device), gen, names)
    del total
    return {"grid": grid.cpu(), "grads": {k: torch.nan_to_num(g).cpu() for k, g in grads.items()}}


def follow(cfg: dict, seed: int, batches, device: str, tf32: bool = False,
           stage: dict = None) -> dict:
    """Run the reference through the followed steps on the program's
    batches, from its own initial parameters and its own draws. Returns
    (on the CPU) the initial parameters, each step's loss, the step-0
    gradients, the parameters after `CHANGE_STEPS` steps, and an NGP
    model's grid before step 0; past `CHANGE_STEPS` steps also the grid
    the last step marched on and, with the program's `stage`, that step's
    refresh and step redone from the program's state (`_stage`); and (on
    the card) the parameters and grid after the last step, under `model`."""
    mp = cfg["model_params"]
    is_ngp = cfg["model"] == "ngp"
    init = (ngp_ref if is_ngp else mip_ref).init_params(mp, seed)
    params = {k: v.to(device, copy=True).requires_grad_(True) for k, v in init.items()}
    names = list(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    last = len(batches) - 1
    out = {"init": init, "losses": [], "grid0": None}
    b1, b2 = cfg.get("adam_beta1", 0.9), cfg.get("adam_beta2", 0.999)
    eps = cfg.get("adam_eps", 1e-6)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    grid = None
    with matmul_precision(tf32):
        if is_ngp:
            shapes = ngp_ref.Shapes(mp)
            grid = torch.zeros(ngp_ref.num_cascades(shapes.scale), shapes.grid_res**3,
                               device=device)
            every = cfg.get("occupancy_update_every", 16)
            warm = cfg.get("occupancy_warmup_steps", 256)
        else:
            basis = mip_ref.sphere_basis().to(device)
        for i, batch in enumerate(batches):
            b = {k: None if t is None else t.to(device) for k, t in batch.items()}
            if is_ngp:
                # The loop's refresh before every `every`-th step: a sweep of
                # every cell during the warm-up, sampled cells after it.
                n_cells = 0 if i < warm else cfg["occupancy_cells_per_update"]
                if i == last and last >= CHANGE_STEPS and stage is not None:
                    out["stage"] = _stage(cfg, shapes, b, gen, names, stage,
                                          n_cells if i % every == 0 else None, device)
                if i % every == 0:
                    grid = ngp_ref.refresh(params, shapes, grid, gen,
                                           cfg.get("occupancy_decay", 0.95), n_cells)
                if i == 0:
                    out["grid0"] = grid.to("cpu", copy=True)
                if i == last and last >= CHANGE_STEPS:
                    out["grid_last"] = grid.to("cpu", copy=True)
                total, grads = _ngp_step(cfg, params, shapes, b, grid, gen, names)
            else:
                renders, history = mip_ref.render(params, mp, b, i / cfg.get("max_steps", 75000),
                                                  gen, basis)
                total = mip_ref.loss(cfg, b, renders, history)
                grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
                grads = {k: torch.zeros_like(params[k]) if g is None else g
                         for k, g in zip(names, grads)}
            out["losses"].append(float(total.detach()))
            with torch.no_grad():
                if not is_ngp and cfg.get("grad_max_norm", 0.001) > 0:
                    for group in mip_ref.groups(params).values():
                        norm = torch.sqrt(sum(torch.sum(grads[k] ** 2) for k in group))
                        mult = torch.clamp(cfg.get("grad_max_norm", 0.001) / (1e-12 + norm),
                                           max=1.0)
                        for k in group:
                            grads[k] = grads[k] * mult
                grads = {k: torch.nan_to_num(g) for k, g in grads.items()}
                if i == 0:
                    out["grads0"] = {k: g.cpu() for k, g in grads.items()}
                lr = lr_at(cfg, i)
                for k, p in params.items():
                    m[k].mul_(b1).add_(grads[k], alpha=1.0 - b1)
                    v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1.0 - b2)
                    c1, c2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
                    denom = v[k].sqrt() / math.sqrt(c2) + eps
                    p.addcdiv_(m[k], denom, value=-lr / c1)
                if i == min(len(batches), CHANGE_STEPS) - 1:
                    out["after"] = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
            del grads
    out["model"] = ({k: p.detach() for k, p in params.items()}, grid)
    return out


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """Largest gap between a leaf's norm and the reference's, over the
    larger of that reference norm and the median leaf's."""
    p, r = _norms(prog), _norms(ref)
    keys = [k for k in r if keep is None or k in keep]
    median = statistics.median(r[k] for k in keys)
    return max(abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keys)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of one program run (or of the control) against the reference."""
    out = {"init_gap": max(float((prog["init"][k] - ref["init"][k]).abs().max())
                           for k in ref["init"])}
    if ref.get("grid0") is not None:
        out["grid_gap"] = float((prog["grid0"] - ref["grid0"]).abs().max()
                                / ref["grid0"].abs().max().clamp(min=1e-30))
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    out["loss_gap"] = max(rel[:CHANGE_STEPS])
    out["grad_gap"] = leaf_gap(prog["grads0"], ref["grads0"])
    if ref.get("grid_last") is not None:
        out["late_loss_gap"] = max(rel[CHANGE_STEPS:])
        mine, theirs = prog["grid_last"].double(), ref["grid_last"].double()
        out["refresh_grid_gap"] = float((mine - theirs).abs().sum()
                                        / theirs.abs().sum().clamp(min=1e-30))
    if ref.get("stage") is not None:
        mine, theirs = prog["stage"], ref["stage"]
        out["stage_grid_gap"] = float((mine["grid"] - theirs["grid"]).abs().max()
                                      / theirs["grid"].abs().max().clamp(min=1e-30))
        out["stage_grad_gap"] = leaf_gap(mine["grads"], theirs["grads"])
    g_norms = _norms(ref["grads0"])
    median = statistics.median(g_norms.values())
    moved = {k for k, n in g_norms.items() if n >= 1e-3 * median}
    delta = lambda run: {k: run["after"][k] - run["init"][k] for k in ref["init"]}
    out["change_gap"] = leaf_gap(delta(prog), delta(ref), moved)
    return out


def program_readings(steps) -> dict:
    """The program's run in the form `compare` takes (`steps`: the driver's FirstSteps)."""
    out = {"init": steps.init_params, "losses": steps.losses, "grads0": steps.grads0,
           "after": steps.params_after, "grid0": steps.grid0, "grid_last": steps.grid_last}
    if steps.grads_last is not None:
        out["stage"] = {"grid": steps.grid_last, "grads": steps.grads_last}
    return out


def stage_inputs(steps):
    """The program's state that `_stage` starts the last followed step from,
    or None (no grid, or too few followed steps)."""
    if steps.grads_last is None or steps.grid_last is None:
        return None
    return {"params": steps.params_last, "grid_prev": steps.grid_prev,
            "grid_last": steps.grid_last}


def half_batches(batches):
    """Each batch's first half of the rays: the other half left out."""
    return [{k: None if t is None else t[: t.shape[0] // 2] for k, t in b.items()} for b in batches]


def check(cfg: dict, seed: int, scene_params: dict, scene_dir: str, steps, device: str,
          limits: dict, control: bool = False) -> dict:
    """{number: (reading, limit)} of the program's followed steps. With
    `control`, also each number of the reference in the program's place
    computed one precision down (TF32), under `control.<number>`, and with
    half of each batch left out, under `fault.half_batch.<number>`."""
    scene = data_ref.Scene(scene_dir, scene_params)
    rays_off = sum(data_ref.batch_errors(scene, b) for b in steps.batches)
    stage = stage_inputs(steps)
    ref = follow(cfg, seed, steps.batches, device, stage=stage)
    numbers = compare(program_readings(steps), ref)
    out = {"batch_rays_off": (float(rays_off), 0.0)}
    out.update({k: (v, limits.get(k, 0.0)) for k, v in numbers.items()})
    if control:
        others = {"control": follow(cfg, seed, steps.batches, device, tf32=True, stage=stage),
                  "fault.half_batch": follow(cfg, seed, half_batches(steps.batches), device,
                                             stage=stage)}
        for name, run in others.items():
            out.update({f"{name}.{k}": (v, limits.get(k, 0.0))
                        for k, v in compare(run, ref).items()})
    return out
