"""The port's data parallelism (`outdoor_nerf_depth_torch/parallel/`) in a
2-rank gloo world on the CPU, held against the reference package's step on
the global batch, run on the test session's 8-device mesh.

One world runs every scenario: this file, launched by torchrun
(`--standalone`, so its rendezvous takes a free port) with two ranks,
reads the inputs the test process wrote, runs each scenario on both ranks
and saves what each rank saw. The rule each case holds: a W-rank step is
the reference's step on the ranks' batches in rank order (the global
batch). The reference computes its losses over the whole sharded batch;
the port's ranks each take their share and sum their gradients in one
all-reduce, so masked denominators split unevenly between the ranks must
still be the global ones.

The test process meanwhile builds the same weights and batches and runs
the reference (and, where the port's own draws are compared, the port in
one process). Only the test process imports JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import traceback

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch import __main__ as t_cli
from outdoor_nerf_depth_torch import parallel
from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import native_batcher as t_native
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.ops import hashgrid as t_hg
from outdoor_nerf_depth_torch.ops import occupancy as t_occ
from outdoor_nerf_depth_torch.train import losses as t_losses
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config as t_load_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
FLAGSHIP = "configs/kitti_mipnerf360.json"
NGP_CONFIG = "configs/kitti_ngp.json"
NERFPP_CONFIG = "configs/kitti_nerfpp.json"
MIP_MODEL = {
    "num_prop_samples": 16, "num_nerf_samples": 8, "num_levels": 3, "raydist_fn": "reciprocal",
    "opaque_background": True, "single_jitter": True,
    "nerf_mlp_params": {"net_depth": 3, "net_width": 32, "bottleneck_width": 16,
                        "net_width_viewdirs": 16, "max_deg_point": 4},
    "prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4},
}
# The flagship at small widths, its depth loss averaged over the rays with
# a valid depth ("mean_valid"), whose count the test splits unevenly.
MIP = ["dataset=synthetic", "batch_size=64", "max_steps=3", "lr_delay_steps=0",
       "randomized=false", "exp_dir=unused", "depth_loss_reduce=mean_valid",
       "model_params=" + json.dumps(MIP_MODEL)]
ACCUM = MIP + ["grad_accum_steps=2"]
NGP_FIELD = dict(n_levels=2, log2_table_size=10, base_resolution=4, max_resolution=16,
                 hidden_width=16, geo_features=7, grad_mode="sorted")
NGP_MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16,
                 field_params=NGP_FIELD, sample_budget=8)
NGP = ["dataset=synthetic", "batch_size=64", "max_steps=3", "randomized=false", "exp_dir=unused",
       "model_params=" + json.dumps(NGP_MODEL)]
NERFPP = ["dataset=synthetic", "batch_size=64", "max_steps=3", "lr_delay_steps=0",
          "exp_dir=unused", "randomized=false", "autoexpo_loss_mult=0.1",
          "model_params=" + json.dumps(dict(cascade_samples=(6, 6), net_depth=2, net_width=16,
                                            pos_degrees=4, view_degrees=2,
                                            optimize_autoexposure=True, num_images=4))]
# Rays whose depth prior is invalid: 3 of rank 0's 32 rows, 20 of rank 1's.
INVALID_DEPTH_ROWS = [1, 7, 30] + list(range(34, 64, 3))[:20]
PLAN_RAYS, PLAN_SLOTS = 64, 16
TABLE_LEVELS, TABLE_LOG2, TABLE_POINTS = 4, 10, 256
CHUNK = 40


# ----------------------------------------------------------------------------
# The ranks' side (run by torchrun; imports no JAX).
# ----------------------------------------------------------------------------


def _stats(stats):
    out = {k: float(stats[k]) for k in ("loss", "psnr", "grad_norm", "rm_s", "vr_s") if k in stats}
    out["loss_terms"] = {k: float(v) for k, v in stats["loss_terms"].items()}
    return out


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _summed(t):
    """`t` summed over the ranks (a new tensor)."""
    out = t.detach().clone()
    parallel.all_reduce_sum_([out])
    return out


def _checksum(model):
    """Every parameter and buffer of each rank, to show they stay replicated."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in model.state_dict().values()])
    return parallel.all_gather_rows(flat[None])


def _model(config, state_dict):
    model = t_step.build_model(config)
    model.load_state_dict(state_dict)
    return model


def _run_steps(config, state_dict, batches, cams, generator=None, grid=None):
    """`len(batches)` steps of the port on this rank's rows of each global
    batch; the stats and parameters after each step."""
    model = _model(config, state_dict)
    if grid is not None:
        model.occupancy.copy_(grid)
    optimizer, lr_fn = t_step.make_optimizer(config, model)
    step = t_step.make_train_step(config, model, optimizer, lr_fn, cameras=cams)
    out = []
    for i, batch in enumerate(batches):
        stats = step(parallel.shard_batch(batch), i, i / config.max_steps, generator)
        out.append({"stats": _stats(stats), "params": _params(model), "checksum": _checksum(model)})
    return model, out


def _scenario_mesh(inputs, tmp):
    mesh = parallel.make_mesh()
    r = mesh.rank
    out = {"mesh": (mesh.rank, mesh.size), "rows": (mesh.rows(64).start, mesh.rows(64).stop)}
    with pytest.raises(ValueError):
        mesh.rows(63)
    out["active"], out["world"] = parallel.active(), parallel.world()
    out["sum"] = _summed(torch.tensor([r + 1.0, 10.0 * r]))
    out["gather_f"] = parallel.all_gather_rows(torch.full((2, 3), r + 0.5))
    out["gather_b"] = parallel.all_gather_rows(torch.tensor([r == 0, True]))
    out["gather_i"] = parallel.all_gather_rows(torch.tensor([r, 7 * r], dtype=torch.int64))
    t = torch.tensor([float(r + 3)])
    parallel.broadcast_([t])
    out["broadcast"] = t
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(r)
    parallel.put_replicated(lin)
    out["replicated"] = lin.weight.detach().clone()
    out["shard"] = parallel.shard_batch({"x": torch.arange(8)})["x"]
    gen = torch.Generator().manual_seed(3)
    with parallel.row_shard(r, WORLD):
        out["rand"] = parallel.mesh.rand((4, 2), generator=gen)
        out["randn"] = parallel.mesh.randn((4,), generator=gen)
    out["rand_whole"] = torch.rand((8, 2), generator=torch.Generator().manual_seed(3))
    return out


def _scenario_datasets(inputs, tmp):
    ds = t_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    out = {"batch_size": ds.batch_size, "batches": [ds.sample_batch() for _ in range(2)]}
    try:
        t_datasets.SyntheticDataset("train", global_batch_size=63, seed=1)
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    return out


def _scenario_losses(inputs, tmp):
    """Each rank's share of the photometric and masked depth losses from the
    summed denominators; the shares summed over the ranks."""
    rows = parallel.make_mesh().rows(64)
    x = {k: torch.from_numpy(v) for k, v in inputs["losses"].items()}
    mine = {k: v[rows] for k, v in x.items()}
    lossmult_sum = _summed(mine["lossmult"].expand(mine["pred"].shape).sum())
    n_valid = _summed((mine["depth_sup"] > 0).sum().double()).float()
    rl, mse = t_losses.rgb_loss(mine["pred"], mine["target"], mine["lossmult"], kind="charb",
                                denom=lossmult_sum)
    dl = t_losses.expected_depth_loss(mine["depth_pred"], mine["depth_sup"], reduce="mean_valid",
                                      n_valid=n_valid)
    local = t_losses.expected_depth_loss(mine["depth_pred"], mine["depth_sup"],
                                         reduce="mean_valid")
    shares = torch.stack([rl, mse, dl])
    return {"global": _summed(shares),
            "local_mean": _summed(local.reshape(1)) / WORLD}


def _scenario_mip(inputs, tmp):
    config = t_load_config(FLAGSHIP, MIP)
    _, out = _run_steps(config, inputs["mip_params"], inputs["mip_batches"], inputs["cams"])
    return out


def _scenario_mip_jitter(inputs, tmp):
    config = t_load_config(FLAGSHIP, MIP + ["randomized=true"])
    _, out = _run_steps(config, inputs["mip_params"], inputs["mip_batches"][:2], inputs["cams"],
                        generator=torch.Generator().manual_seed(5))
    return out


def _scenario_accum(inputs, tmp):
    out = {}
    for n in (2, 4):
        config = t_load_config(FLAGSHIP, MIP + [f"grad_accum_steps={n}"])
        _, out[n] = _run_steps(config, inputs["mip_params"], inputs["mip_batches"][:1],
                               inputs["cams"])
    config = t_load_config(FLAGSHIP, MIP + ["grad_accum_steps=3", "batch_size=96"])
    try:
        _run_steps(config, inputs["mip_params"], [inputs["plan_batch96"]], inputs["cams"])
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def _scenario_plan(inputs, tmp):
    r = parallel.rank()
    out = {}
    for name, (valid, budget) in inputs["plans"].items():
        valid = torch.from_numpy(valid)
        mine = valid[parallel.make_mesh().rows(valid.shape[0])]
        with parallel.row_shard(r, WORLD):
            sel, inv = t_occ.batch_compaction_plan(mine, mine.shape[0] * budget)
        out[name] = {"sel": sel, "inv": inv}
    return out


def _scenario_table_grad(inputs, tmp):
    x, table, g = (torch.from_numpy(a) for a in inputs["table"])
    rows = parallel.make_mesh().rows(x.shape[0])
    res = tuple(int(v) for v in t_hg.level_resolutions(TABLE_LEVELS, 4, 64))
    tt = table.clone().requires_grad_(True)
    out = t_hg.OctSplitEncode.apply(x[rows], tt, res, 2**TABLE_LOG2)
    (out * g[rows]).sum().backward()
    grad = tt.grad.clone()
    parallel.all_reduce_sum_([grad])
    return {"grad": grad}


def _scenario_ngp(inputs, tmp):
    config = t_load_config(NGP_CONFIG, NGP)
    grid = torch.from_numpy(inputs["ngp_grid"])
    # The render's batch plan spans each chunk's rows on both ranks.
    model = _model(config, inputs["ngp_params"])
    model.occupancy.copy_(grid)
    render = t_step.render_image(model, inputs["render_batch"], CHUNK, "cpu")
    update = t_step.make_occupancy_update_fn(config, model)
    # Refreshed from a generator seeded per rank, then rank 0's grid broadcast.
    refreshed = update(model.occupancy, torch.Generator().manual_seed(9 + parallel.rank()), True)
    _, out = _run_steps(config, inputs["ngp_params"], inputs["ngp_batches"], inputs["cams"],
                        grid=grid)
    return {"steps": out, "grid": refreshed, "render": render}


def _scenario_nerfpp(inputs, tmp):
    config = t_load_config(NERFPP_CONFIG, NERFPP)
    _, out = _run_steps(config, inputs["nerfpp_params"], inputs["nerfpp_batches"],
                        inputs["cams"])
    return out


def _scenario_render(inputs, tmp):
    config = t_load_config(FLAGSHIP, MIP)
    model = _model(config, inputs["mip_params"])
    return t_step.render_image(model, inputs["render_batch"], CHUNK, "cpu")


class _OneBatch(t_datasets.SyntheticDataset):
    """Serves one batch (this rank's share) every step, so two runs see the
    same batches."""

    def __init__(self):
        super().__init__("train", global_batch_size=64, seed=1)
        self._batch = super().sample_batch()

    def sample_batch(self):
        return self._batch


class _Interrupt(Exception):
    pass


def _cut_after(n):
    """A `make_train_step` whose step raises on its (n + 1)-th call, on
    every rank alike, as a run killed after step n."""
    real = t_step.make_train_step

    def make(*args, **kwargs):
        step, calls = real(*args, **kwargs), []

        def cut(*step_args):
            if len(calls) == n:
                raise _Interrupt
            calls.append(None)
            return step(*step_args)

        return cut

    return make


def _scenario_loop(inputs, tmp):
    """4 steps in one run, and a run killed after step 2 then resumed."""
    base = MIP[:-1] + ["max_steps=4", "checkpoint_every=2", "print_every=1",
                       "use_native_batcher=false", "randomized=true",
                       "model_params=" + json.dumps(MIP_MODEL)]
    whole, cut = os.path.join(tmp, "loop_whole"), os.path.join(tmp, "loop_cut")
    lines = []
    model_a, hist_a = t_loop.train(t_load_config(FLAGSHIP, base + [f"exp_dir={whole}"]),
                                   device="cpu", log_fn=lines.append, dataset=_OneBatch())
    cut_config = t_load_config(FLAGSHIP, base + [f"exp_dir={cut}"])
    real = t_step.make_train_step
    t_step.make_train_step = _cut_after(2)  # the module the loop calls it from
    try:
        t_loop.train(cut_config, device="cpu", log_fn=lines.append, dataset=_OneBatch())
    except _Interrupt:
        pass
    finally:
        t_step.make_train_step = real
    model_b, hist_b = t_loop.train(cut_config, device="cpu", log_fn=lines.append,
                                   dataset=_OneBatch())
    same = all(torch.equal(v, model_b.state_dict()[k]) for k, v in model_a.state_dict().items())
    return {"lines": lines, "hist_whole": hist_a, "hist_resumed": hist_b, "resume_equal": same,
            "checksum": _checksum(model_a), "whole": whole}


def _scenario_cli(inputs, tmp):
    exp = os.path.join(tmp, "cli")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_cli.main(["--config", FLAGSHIP, "--device", "cpu", *MIP[:-2], "max_steps=2",
                    "print_every=1", "randomized=true", f"exp_dir={exp}",
                    "model_params=" + json.dumps(MIP_MODEL)])
    return {"stdout": buf.getvalue(), "exp": exp, "still_active": parallel.active()}


def _scenario_fault5(inputs, tmp):
    ds = t_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    config = t_load_config(FLAGSHIP, MIP[:-1] + ["model_params=" + json.dumps(MIP_MODEL)])
    assert t_native.applies(config, ds)
    batcher = t_native.NativeRayBatcher(ds, seed=config.seed, num_threads=1)
    return {"batch_size": ds.batch_size, "batch": batcher.sample_batch()}


SCENARIOS = {name[len("_scenario_"):]: fn for name, fn in dict(globals()).items()
             if name.startswith("_scenario_")}


def _worker(workdir):
    """One rank: join the world torchrun describes, run every scenario."""
    sys.modules["torch.utils.tensorboard"] = None  # the metric writer's JSONL only
    device = parallel.init_from_env("cpu")
    assert device.type == "cpu"
    r = parallel.rank()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    results = {}
    for name, fn in SCENARIOS.items():
        try:
            results[name] = fn(inputs, workdir)
        except Exception:  # recorded, so each test reports its own scenario
            results[name] = {"error": traceback.format_exc()}
        parallel.barrier()
    torch.save(results, os.path.join(workdir, f"rank{r}.pt"))
    parallel.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------------------------
# The test process's side.
# ----------------------------------------------------------------------------


def _to_torch(obj):
    """A reference Batch/Rays/Pixels as the port's, float32/int32 CPU tensors."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_rays, type(obj).__name__)
        return cls(**{f.name: _to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    x = np.asarray(obj)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x.copy())


def _mask_depth(batch):
    """The batch with INVALID_DEPTH_ROWS' depth prior invalid (-1)."""
    sup = np.array(batch.depth_sup, copy=True)
    sup[INVALID_DEPTH_ROWS] = -1.0
    return dataclasses.replace(batch, depth_sup=sup)


def _plan_masks():
    rng = np.random.default_rng(11)
    # Valid slots thin out along the ray: at 5 of 16 slots a ray the cut
    # falls inside one slot index; at 8 the sparse mask fits the budget.
    dense = rng.uniform(size=(PLAN_RAYS, PLAN_SLOTS)) < np.linspace(0.95, 0.3, PLAN_SLOTS)
    sparse = rng.uniform(size=(PLAN_RAYS, PLAN_SLOTS)) < 0.3
    dense[40:] &= rng.uniform(size=(PLAN_RAYS - 40, PLAN_SLOTS)) < 0.5  # rank 1 sparser
    return {"overflow": (dense, 5), "fits": (sparse, 8)}


def _flax_to_port(params, config):
    """The port's model holding the reference's parameters."""
    from outdoor_nerf_depth_torch import convert

    return convert.params_from_flax(params, t_step.build_model(config))


def _flat(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes the inputs, starts the 2-rank world, runs the reference (and
    the port in one process) meanwhile, and returns both sides."""
    import jax
    import jax.numpy as jnp

    from outdoor_nerf_depth_tpu import parallel as j_parallel
    from outdoor_nerf_depth_tpu.data import datasets as j_datasets
    from outdoor_nerf_depth_tpu.data import rays as j_rays
    from outdoor_nerf_depth_tpu.ops import hashgrid as j_hg
    from outdoor_nerf_depth_tpu.ops import occupancy as j_occ
    from outdoor_nerf_depth_tpu.train import losses as j_losses
    from outdoor_nerf_depth_tpu.train import step as j_step
    from outdoor_nerf_depth_tpu.train.config import load_config as j_load_config

    tmp = str(tmp_path_factory.mktemp("ddp"))
    mesh8 = j_parallel.make_mesh()
    assert len(mesh8.devices.flat) == 8
    dataset = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    mip_batches = [_mask_depth(dataset.sample_batch()) for _ in range(3)]
    ngp_batches = [dataset.sample_batch()]
    nerfpp_batches = [dataset.sample_batch()]
    batch96 = j_datasets.SyntheticDataset("train", global_batch_size=96, seed=1).sample_batch()
    render_batch = j_datasets.SyntheticDataset("test", seed=2).image_batch(1)
    rng = np.random.default_rng(5)
    losses_in = {
        "pred": rng.uniform(size=(64, 3)).astype(np.float32),
        "target": rng.uniform(size=(64, 3)).astype(np.float32),
        "lossmult": np.ones((64, 1), np.float32),
        "depth_pred": rng.uniform(1, 10, size=(64,)).astype(np.float32),
        "depth_sup": rng.uniform(1, 10, size=(64,)).astype(np.float32),
    }
    losses_in["depth_sup"][INVALID_DEPTH_ROWS] = -1.0
    table_in = (rng.uniform(-0.05, 1.05, (TABLE_POINTS, 3)).astype(np.float32),
                rng.normal(0.0, 0.1, (TABLE_LEVELS, 2**TABLE_LOG2, 2)).astype(np.float32),
                rng.normal(size=(TABLE_POINTS, TABLE_LEVELS * 2)).astype(np.float32))
    ngp_grid = np.ones((1, 16**3), np.float32)  # every cell occupied: the untrained state

    configs_j = {k: j_load_config(path, ov) for k, (path, ov) in {
        "mip": (FLAGSHIP, MIP), "accum": (FLAGSHIP, ACCUM), "ngp": (NGP_CONFIG, NGP),
        "nerfpp": (NERFPP_CONFIG, NERFPP)}.items()}
    configs_t = {"mip": t_load_config(FLAGSHIP, MIP), "ngp": t_load_config(NGP_CONFIG, NGP),
                 "nerfpp": t_load_config(NERFPP_CONFIG, NERFPP)}
    with jax.default_matmul_precision("highest"):
        init = {}
        for k in ("mip", "ngp", "nerfpp"):
            model_j = j_step.build_model(configs_j[k])
            init[k] = jax.device_get(jax.jit(lambda key, m=model_j: m.init(
                key, rng=None, rays=j_rays.dummy_rays((8,)), train_frac=1.0,
                compute_extras=False))(jax.random.PRNGKey(0)))
    inputs = {
        "mip_params": _flax_to_port(init["mip"], configs_t["mip"]).state_dict(),
        "ngp_params": _flax_to_port(init["ngp"], configs_t["ngp"]).state_dict(),
        "nerfpp_params": _flax_to_port(init["nerfpp"], configs_t["nerfpp"]).state_dict(),
        "mip_batches": [_to_torch(b) for b in mip_batches],
        "ngp_batches": [_to_torch(b) for b in ngp_batches],
        "nerfpp_batches": [_to_torch(b) for b in nerfpp_batches],
        "plan_batch96": _to_torch(batch96),
        "cams": tuple(None if c is None else torch.from_numpy(c) for c in dataset.cameras),
        "render_batch": _to_torch(render_batch),
        "ngp_grid": ngp_grid, "losses": losses_in, "table": table_in, "plans": _plan_masks(),
    }
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", os.path.abspath(__file__), tmp],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    ref = {}
    try:
        with jax.default_matmul_precision("highest"):
            # The reference's steps on the global batches, sharded over 8 devices.
            for k, batches, aux in (("mip", mip_batches, None), ("accum", mip_batches[:1], None),
                                    ("ngp", ngp_batches, jnp.asarray(ngp_grid)),
                                    ("nerfpp", nerfpp_batches, None)):
                config_j = configs_j[k]
                model_j = j_step.build_model(config_j)
                state = j_step.TrainState.create(
                    apply_fn=model_j.apply, params=init["ngp" if k == "ngp" else
                                                        "nerfpp" if k == "nerfpp" else "mip"],
                    tx=j_step.make_optimizer(config_j)[0])
                step_j = j_step.make_train_step(config_j, model_j, mesh8, cameras=dataset.cameras,
                                                camtype=dataset.camtype)
                ref[k] = []
                for i, b in enumerate(batches):
                    args = (state, j_parallel.shard_batch(b, mesh8), jax.random.PRNGKey(i),
                            i / config_j.max_steps)
                    state, stats = step_j(*args, aux) if aux is not None else step_j(*args)
                    ref[k].append({"stats": jax.device_get(stats), "params": _flat(
                        _flax_to_port(jax.device_get(state.params), configs_t[
                            "mip" if k == "accum" else k]))})
            ref["render"] = j_step.render_image(
                j_step.make_render_fn(configs_j["mip"], j_step.build_model(configs_j["mip"]),
                                      mesh8), init["mip"], render_batch, mesh8, chunk_size=CHUNK)
            ref["ngp_render"] = j_step.render_image(
                j_step.make_render_fn(configs_j["ngp"], j_step.build_model(configs_j["ngp"]),
                                      mesh8), init["ngp"], render_batch, mesh8, chunk_size=CHUNK,
                aux=jnp.asarray(ngp_grid))
            ref["plans"] = {
                name: np.asarray(jax.jit(j_occ.batch_compaction_plan, static_argnums=1)(
                    jnp.asarray(valid), PLAN_RAYS * budget)[0])
                for name, (valid, budget) in _plan_masks().items()}
            l = {k: jnp.asarray(v) for k, v in losses_in.items()}
            rl, mse = j_losses.rgb_loss(l["pred"], l["target"], l["lossmult"], kind="charb")
            dl = j_losses.expected_depth_loss(l["depth_pred"], l["depth_sup"],
                                              reduce="mean_valid")
            ref["losses"] = np.array([float(rl), float(mse), float(dl)])
            res = tuple(int(v) for v in j_hg.level_resolutions(TABLE_LEVELS, 4, 64))
            fn = j_hg._oct_split_grad_encode(res, 2**TABLE_LOG2)
            x, table, g = (jnp.asarray(a) for a in table_in)
            try:
                j_hg.set_grad_mesh(mesh8)
                xs = jax.device_put(x, j_parallel.batch_sharding(mesh8))
                ref["table_grad"] = np.asarray(jax.jit(jax.grad(
                    lambda a, t: jnp.sum(fn(a, t) * g), argnums=1))(xs, table))
            finally:
                j_hg.set_grad_mesh(None)

        # The port in one process, for the draws and the chunks the
        # reference draws or cuts otherwise.
        one = {}
        gen = torch.Generator().manual_seed(5)
        for key, extra, n_batches, generator in (("jitter", ["randomized=true"], 2, gen),
                                                 ("accum4", ["grad_accum_steps=4"], 1, None)):
            config = t_load_config(FLAGSHIP, MIP + extra)
            model = t_step.build_model(config)
            model.load_state_dict(inputs["mip_params"])
            optimizer, lr_fn = t_step.make_optimizer(config, model)
            step = t_step.make_train_step(config, model, optimizer, lr_fn, cameras=inputs["cams"])
            one[key] = []
            for i, b in enumerate(inputs["mip_batches"][:n_batches]):
                stats = step(b, i, i / config.max_steps, generator)
                one[key].append({"stats": _stats(stats), "params": _flat(model)})
        model = t_step.build_model(configs_t["ngp"])
        model.load_state_dict(inputs["ngp_params"])
        model.occupancy.copy_(torch.from_numpy(ngp_grid))
        one["ngp_render"] = t_step.render_image(model, inputs["render_batch"], CHUNK, "cpu")
        update = t_step.make_occupancy_update_fn(configs_t["ngp"], model)
        one["ngp_grid"] = update(model.occupancy, torch.Generator().manual_seed(9), True)
        model = t_step.build_model(configs_t["mip"])
        model.load_state_dict(inputs["mip_params"])
        one["render"] = t_step.render_image(model, inputs["render_batch"], CHUNK, "cpu")
    finally:
        out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-6000:]
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "one": one, "inputs": inputs, "tmp": tmp,
            "configs_t": configs_t}


def _result(world, name, rank=0):
    res = world["ranks"][rank][name]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank}, scenario {name}:\n{res['error']}")
    return res


def _assert_replicated(entry):
    cs = entry["checksum"]
    assert torch.equal(cs[0], cs[1]), "the ranks' parameters differ"


def _assert_step_matches(got, want, loss_rtol, params_atol, grad_rtol=1e-4):
    st, sj = got["stats"], want["stats"]
    assert set(st["loss_terms"]) == set(sj["loss_terms"])
    for k, v in sj["loss_terms"].items():
        np.testing.assert_allclose(st["loss_terms"][k], float(v), rtol=loss_rtol, atol=1e-8,
                                   err_msg=k)
    np.testing.assert_allclose(st["loss"], float(sj["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(st["psnr"], float(sj["psnr"]), rtol=1e-5)
    np.testing.assert_allclose(st["grad_norm"], float(sj["grad_norm"]), rtol=grad_rtol)
    pt, pj = {n: p.numpy() for n, p in got["params"].items()}, want["params"]
    assert set(pt) == set(pj)
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=params_atol, rtol=1e-5, err_msg=name)


# ----------------------------------------------------------------------------
# The cases.
# ----------------------------------------------------------------------------


def test_mesh_helpers(world):
    for r in range(WORLD):
        got = _result(world, "mesh", r)
        assert got["mesh"] == (r, WORLD) and got["active"] and got["world"] == WORLD
        assert got["rows"] == (32 * r, 32 * (r + 1))
        assert got["sum"].tolist() == [3.0, 10.0]
        assert got["gather_f"].tolist() == [[0.5] * 3] * 2 + [[1.5] * 3] * 2
        assert got["gather_b"].tolist() == [True, True, False, True]
        assert got["gather_i"].dtype == torch.int64 and got["gather_i"].tolist() == [0, 0, 1, 7]
        assert got["broadcast"].tolist() == [3.0]
        assert torch.equal(got["replicated"], torch.zeros(2, 2))
        assert got["shard"].tolist() == list(range(4 * r, 4 * r + 4))
        # A rank's draws are its rows of the whole batch's draw, exactly.
        assert torch.equal(got["rand"], got["rand_whole"][4 * r:4 * r + 4])
    whole = torch.Generator().manual_seed(3)
    torch.rand((8, 2), generator=whole)
    want_n = torch.randn((8,), generator=whole)
    for r in range(WORLD):
        assert torch.equal(_result(world, "mesh", r)["randn"], want_n[4 * r:4 * r + 4])


def test_without_a_group_the_mesh_is_one_process(monkeypatch):
    for key in parallel.mesh.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert not parallel.active() and parallel.world() == 1 and parallel.rank() == 0
    assert parallel.make_mesh() == parallel.Mesh(0, 1)
    assert not parallel.mesh.in_torchrun_env()
    assert parallel.mesh.in_torchrun_env({k: "0" for k in parallel.mesh.ENV_KEYS})
    x = torch.arange(6)
    assert torch.equal(parallel.shard_batch(x), x)
    assert torch.equal(parallel.all_gather_rows(x), x)
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.init_from_env("cpu")


def _remat_grads(remat, shard_index, backward_on_a_thread):
    """Gradients of one forward and loss of the small flagship drawn as
    rank `shard_index` of 2's rows, its backward run on a new thread (which
    starts from an empty context, as autograd's device threads do) or on
    this one."""
    config = t_load_config(FLAGSHIP, MIP + [f"remat={remat}"])
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(0))
    dataset = t_datasets.SyntheticDataset("train", global_batch_size=32, n_images=4,
                                          height=12, width=16, seed=3)
    batch = dataset.sample_batch()
    rays = t_cameras.cast_pixels(batch.rays, dataset.cameras_on("cpu"), dataset.camtype)
    forward = t_step.make_forward(config, model, compute_extras=True)
    with parallel.row_shard(shard_index, WORLD):
        renderings, history = forward(rays, 0.5, torch.Generator().manual_seed(2))
        loss_terms, _ = t_step._total_loss(config, batch, renderings, history, rays)
        total = sum(loss_terms.values())
    errors = []

    def backward():
        try:
            total.backward()
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)

    if backward_on_a_thread:
        thread = threading.Thread(target=backward)
        thread.start()
        thread.join()
    else:
        backward()
    if errors:
        raise errors[0]
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recompute_on_another_thread_draws_the_forward_rows(remat):
    """A checkpoint's recompute runs inside the backward, which autograd
    runs on its own thread on a card: there it still draws this rank's rows
    of the global batch's jitter, as the forward did, so the gradients equal
    the plain forward's (bit for bit: the same ops on the same draws)."""
    plain = _remat_grads("none", 1, backward_on_a_thread=False)
    got = _remat_grads(remat, 1, backward_on_a_thread=True)
    assert set(got) == set(plain)
    for name, g in plain.items():
        assert torch.equal(got[name], g), name
    # The rows matter: rank 0's rows of the same draw give other gradients.
    other = _remat_grads("none", 0, backward_on_a_thread=False)
    assert any(not torch.equal(other[n], g) for n, g in plain.items())


def test_cli_without_torchrun_env_makes_no_process_group(monkeypatch, tmp_path):
    for key in parallel.mesh.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)

    def refuse(*args, **kwargs):
        raise AssertionError("joined a process group")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL logs only
    monkeypatch.setattr(parallel, "init_from_env", refuse)
    monkeypatch.setattr(t_loop.torch.distributed, "init_process_group", refuse)
    t_cli.main(["--config", FLAGSHIP, "--device", "cpu", "--no-eval", *MIP[:-2], "max_steps=1",
                "use_native_batcher=false", f"exp_dir={tmp_path}",
                "model_params=" + json.dumps(MIP_MODEL)])
    assert not parallel.active()


def test_a_failed_nccl_init_raises_and_falls_back_to_nothing(monkeypatch):
    """This build has no NCCL (and no card): joining with it raises, and no
    group of another backend is made."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Exception):
        parallel.init_from_env("cpu", backend="nccl", timeout_s=5)
    assert not parallel.active()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_from_env()
    assert not parallel.active()


def test_each_rank_batch_equals_the_reference_process_batch(world, monkeypatch):
    """Rank r's dataset serves its half of the global batch from the stream
    of the reference's process r, exactly."""
    import jax

    from outdoor_nerf_depth_tpu.data import datasets as j_datasets

    for r in range(WORLD):
        got = _result(world, "datasets", r)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        ref = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
        assert got["batch_size"] == ref.batch_size == 32
        for batch in got["batches"]:
            want = ref.sample_batch()
            for name in ("pix_x", "pix_y", "cam_idx", "lossmult", "near", "far"):
                np.testing.assert_array_equal(getattr(batch.rays, name).numpy(),
                                              np.asarray(getattr(want.rays, name)), err_msg=name)
            for name in ("rgb", "depth_gt", "depth_sup"):
                np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                              np.asarray(getattr(want, name)), err_msg=name)


def test_a_world_that_does_not_divide_the_batch_raises(world):
    for r in range(WORLD):
        assert "not divisible by 2 processes" in _result(world, "datasets", r)["odd"]


def test_global_denominators_with_depths_split_unevenly(world):
    """The ranks' shares of charb's lossmult mean, the mse behind psnr and
    the depth loss averaged over valid rays (3 invalid on rank 0, 20 on
    rank 1) sum to the reference's losses on the global batch (relative
    1e-6: float32 sums in another order). Means of per-rank losses would
    not: the depth loss's local mean is off by more than 1%."""
    got = _result(world, "losses")
    want = world["ref"]["losses"]
    np.testing.assert_allclose(got["global"].numpy(), want, rtol=1e-6)
    assert abs(float(got["local_mean"][0]) - want[2]) > 0.01 * want[2]


@pytest.mark.parametrize("n_steps", [1, 3])
def test_mip_steps_match_the_reference_global_step(world, n_steps):
    """Three flagship steps at small widths (deterministic sampling), the
    depth loss over valid rays split unevenly: the 2-rank step against the
    reference's step on the global batch over 8 devices, at the tolerances
    of the one-process test (`tests/test_torch_train_step.py`): loss terms
    at relative 3e-5, psnr 1e-5, the gradient norm 1e-4, parameters 2e-5
    absolute and 1e-5 relative. Both ranks hold the same parameters."""
    for r in range(WORLD):
        got = _result(world, "mip", r)[n_steps - 1]
        _assert_replicated(got)
        _assert_step_matches(got, world["ref"]["mip"][n_steps - 1], 3e-5, 2e-5)


def test_jitter_equals_one_process_fed_the_global_batch(world):
    """With jitter on, each rank draws the global batch's jitter from the
    shared generator and takes its rows: two steps equal one process's on
    the concatenated batch (float32 sums in another order: relative 1e-5,
    parameters 1e-6 absolute)."""
    for r in range(WORLD):
        for got, want in zip(_result(world, "mip_jitter", r), world["one"]["jitter"]):
            _assert_replicated(got)
            st, so = got["stats"], want["stats"]
            for k, v in so["loss_terms"].items():
                np.testing.assert_allclose(st["loss_terms"][k], v, rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(st["grad_norm"], so["grad_norm"], rtol=1e-5)
            for name, p in got["params"].items():
                np.testing.assert_allclose(p.numpy(), want["params"][name], atol=1e-6,
                                           rtol=1e-5, err_msg=name)


def test_grad_accum_two_chunks_match_the_reference(world):
    """`grad_accum_steps=2` cuts the global batch into rows [0, 32) and
    [32, 64), one on each rank, with 29 and 12 valid depths: one step
    against the reference's at the mip tolerances."""
    got = _result(world, "accum")[2][0]
    _assert_replicated(got)
    _assert_step_matches(got, world["ref"]["accum"][0], 3e-5, 2e-5)


def test_grad_accum_four_chunks_equal_one_process(world):
    """Four chunks, two a rank: the step equals one process's with the same
    four chunks (relative 1e-5, parameters 1e-6)."""
    got = _result(world, "accum")[4][0]
    want = world["one"]["accum4"][0]
    _assert_replicated(got)
    for k, v in want["stats"]["loss_terms"].items():
        np.testing.assert_allclose(got["stats"]["loss_terms"][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["stats"]["psnr"], want["stats"]["psnr"], rtol=1e-6)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][name], atol=1e-6, rtol=1e-5)


def test_grad_accum_that_splits_a_rank_raises(world):
    for r in range(WORLD):
        assert "grad_accum_steps=3 over 2 ranks" in _result(world, "accum", r)["uneven"]


@pytest.mark.parametrize("name", ["overflow", "fits"])
def test_ngp_plan_equals_the_global_plan(world, name):
    """Each rank's slots are exactly the reference plan's slots of its rows,
    in the same order; on overflow the cut inside one slot index favours
    rank 0, so the ranks keep different counts."""
    want = world["ref"]["plans"][name]
    m = PLAN_RAYS // WORLD * PLAN_SLOTS
    kept = []
    for r in range(WORLD):
        got = _result(world, "plan", r)[name]
        sel, inv = got["sel"].numpy(), got["inv"].numpy()
        mine = want[(want >= r * m) & (want < (r + 1) * m)] - r * m
        np.testing.assert_array_equal(sel, mine)
        np.testing.assert_array_equal(inv[sel], np.arange(len(sel)))
        assert (inv >= len(sel)).sum() == m - len(sel)
        kept.append(len(sel))
    assert sum(kept) == len(want)
    budget = _plan_masks()[name][1] * PLAN_RAYS // WORLD
    if name == "overflow":
        assert kept[0] > budget > kept[1]


def test_table_gradient_matches_the_reference_shard_map_path(world):
    """Each rank's sorted row sums over its half of the points, summed by
    the all-reduce, against the reference's shard-local row sums and psum
    on 8 devices (`set_grad_mesh`), at the hash-grid test's 1e-4."""
    got = _result(world, "table_grad")["grad"].numpy()
    want = world["ref"]["table_grad"]
    assert np.abs(want).sum() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ngp_step_matches_the_reference_global_step(world):
    """One NGP step through an all-occupied (untrained) grid, so every ray's
    16 valid slots overflow the budget of 8: the global plan on both ranks
    against the reference's step over 8 devices, at `tests/test_torch_ngp.py`'s
    tolerances (loss terms relative 2e-5, gradient norm 1e-4, parameters
    5e-5 absolute; the marching counters to relative 1e-6)."""
    want = world["ref"]["ngp"][0]
    for r in range(WORLD):
        got = _result(world, "ngp", r)["steps"][0]
        _assert_replicated(got)
        for k in ("rm_s", "vr_s"):
            np.testing.assert_allclose(got["stats"][k], float(want["stats"][k]), rtol=1e-6)
        _assert_step_matches(got, want, 2e-5, 5e-5)


def test_occupancy_grids_equal_across_ranks(world):
    """After a refresh every rank holds rank 0's grid bit for bit, though
    rank 1 refreshed from another generator; and rank 0's grid is one
    process's (relative 1e-6)."""
    g0, g1 = (_result(world, "ngp", r)["grid"] for r in range(WORLD))
    assert torch.equal(g0, g1)
    np.testing.assert_allclose(g0.numpy(), world["one"]["ngp_grid"].numpy(), rtol=1e-6,
                               atol=1e-7)


def test_nerfpp_step_matches_the_reference_global_step(world):
    """One NeRF++ step (deterministic sampling, autoexposure and its
    regularizer on, the gradient clipped to norm 1) against the reference's
    step over 8 devices, at `tests/test_torch_nerfpp.py`'s tolerances."""
    want = world["ref"]["nerfpp"][0]
    for r in range(WORLD):
        got = _result(world, "nerfpp", r)[0]
        _assert_replicated(got)
        _assert_step_matches(got, want, 1e-5, 1e-5)


def test_render_image_matches_one_process_and_the_reference(world):
    """Each chunk of 40 rays split over the ranks and gathered: the image one
    process renders (1e-6) and the reference's (the one-process test's 2e-5
    absolute, 1e-4 relative); every rank returns the whole image."""
    ref, one = world["ref"]["render"], world["one"]["render"]
    for r in range(WORLD):
        got = _result(world, "render", r)
        assert set(got) == set(one) == {k for k in ref if not k.startswith("ray_")}
        for key in got:
            assert got[key].shape == one[key].shape
            np.testing.assert_allclose(got[key], one[key], atol=1e-6, rtol=1e-6, err_msg=key)
            np.testing.assert_allclose(got[key], np.asarray(ref[key]), atol=2e-5, rtol=1e-4,
                                       err_msg=key)


def test_ngp_render_plans_over_the_chunk(world):
    """NGP at budget 8 through the all-occupied grid: each chunk's plan spans
    both ranks' rows, and the image equals one process's (1e-6) and the
    reference's (2e-5 absolute)."""
    ref, one = world["ref"]["ngp_render"], world["one"]["ngp_render"]
    for r in range(WORLD):
        got = _result(world, "ngp", r)["render"]
        for key in one:
            np.testing.assert_allclose(got[key], one[key], atol=1e-6, rtol=1e-6, err_msg=key)
            np.testing.assert_allclose(got[key], np.asarray(ref[key]), atol=2e-5, rtol=1e-5,
                                       err_msg=key)


def test_loop_writes_once_and_its_resume_equals_the_whole_run(world):
    """train() on both ranks for 4 steps with checkpoints at 2 and 4: one
    config, one sidecar, one log line a step and one checkpoint a step, all
    from rank 0; the run cut at 2 and resumed equals it bit for bit on both
    ranks, and the log's per-chip rate is the global rate over 2."""
    lead, other = _result(world, "loop", 0), _result(world, "loop", 1)
    assert lead["resume_equal"] and other["resume_equal"]
    assert torch.equal(lead["checksum"][0], lead["checksum"][1])
    assert other["lines"] == []
    steps = [json.loads(x).get("step") for x in lead["lines"] if "loss" in x]
    assert steps == [1, 2, 3, 4, 1, 2, 3, 4]
    assert json.loads(lead["lines"][-3]) == {"restored_step": 2}
    exp = lead["whole"]
    assert sorted(os.listdir(exp)) == ["checkpoints", "config.json", "logs"]
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["2", "4", "model_meta.json"]
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(x)["step"] for x in f]
    assert logged == [1, 2, 3, 4]
    for entry in lead["hist_whole"]:
        assert entry["rays_per_sec_per_chip"] == entry["rays_per_sec"] / WORLD
    for a, b in zip(lead["hist_whole"][2:], lead["hist_resumed"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for a, b in zip(lead["hist_whole"], other["hist_whole"]):
        assert a["loss"] == b["loss"]


def test_cli_in_a_group_logs_and_writes_on_rank_0(world):
    lead, other = _result(world, "cli", 0), _result(world, "cli", 1)
    assert other["stdout"] == ""
    lines = [json.loads(x) for x in lead["stdout"].splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines if "loss" in x] == [1, 2]
    assert lines[-1]["split"] == "test" and np.isfinite(lines[-1]["mean"]["psnr"])
    renders = os.listdir(os.path.join(lead["exp"], "renders"))
    assert "color_000.png" in renders and "summary_000.png" in renders
    # The CLI leaves alone a group it did not join.
    assert lead["still_active"] and other["still_active"]


def test_fault_5_every_rank_draws_the_same_rays_in_both_packages(world, monkeypatch):
    """Under the dataplane each rank's batcher is seeded with the config's
    seed alone, in the port and in the reference: both ranks draw the same
    32 rays, so the global batch holds two copies of one half."""
    import jax

    from outdoor_nerf_depth_tpu.data import datasets as j_datasets
    from outdoor_nerf_depth_tpu.data import native_batcher as j_native

    got = [_result(world, "fault5", r) for r in range(WORLD)]
    assert got[0]["batch_size"] == got[1]["batch_size"] == 32
    a, b = got[0]["batch"], got[1]["batch"]
    for name in ("origins", "directions"):
        assert torch.equal(getattr(a.rays, name), getattr(b.rays, name)), name
    assert torch.equal(a.rgb, b.rgb)
    ref = []
    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        ds = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
        ref.append(j_native.NativeRayBatcher(ds, seed=0, num_threads=1).sample_batch())
    np.testing.assert_array_equal(np.asarray(ref[0].rays.origins), np.asarray(ref[1].rays.origins))
    np.testing.assert_array_equal(np.asarray(ref[0].rgb), np.asarray(ref[1].rgb))
    np.testing.assert_array_equal(a.rays.directions.numpy(), np.asarray(ref[0].rays.directions))
    np.testing.assert_array_equal(a.rgb.numpy(), np.asarray(ref[0].rgb))
