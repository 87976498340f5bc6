"""The operating points the repository's `bench.py` and the probes share.

- `ngp_bench_config`: Instant-NGP at the KITTI training shape (`bench.py`'s
  `_ngp_setup`): scale 0.5, `max_samples` slots a ray from 4x as many
  candidates, bfloat16, depth mse at 0.1, opacity 1e-3, no LR delay.
- `nerfpp_bench_config`: NeRF++ at the KITTI shape (the NeRF++ probes'):
  cascade 64 + 128, fg and bg 8x256 fields, position degrees 10, view 4,
  bfloat16, depth mse at 0.1 averaged over valid depths, coarse rgb loss 1.
- `bench_scene`: the synthetic scene of 8 views of 94x310 at seed 0.
- `bench_trainer`: a model, its optimizer and train step on that scene, a
  generator and a few batches on the device, as the probes time them.
"""

from __future__ import annotations

import dataclasses

import torch

from outdoor_nerf_depth_torch.data import datasets as datasets_lib
from outdoor_nerf_depth_torch.data import rays as rays_lib
from outdoor_nerf_depth_torch.train import step as step_lib
from outdoor_nerf_depth_torch.train.config import Config

N_IMAGES, HEIGHT, WIDTH, SCENE_SEED = 8, 94, 310, 0
NERFPP_MODEL = dict(cascade_samples=(64, 128), net_depth=8, net_width=256, pos_degrees=10,
                    view_degrees=4, compute_dtype="bfloat16")


def ngp_bench_config(batch: int, max_samples: int = 64, **model_params) -> Config:
    """The NGP bench config; `model_params` add to or replace its model's."""
    params = dict(scale=0.5, max_samples=max_samples, n_candidates=4 * max_samples,
                  compute_dtype="bfloat16")
    params.update(model_params)
    return Config(
        model="ngp", model_params=params, compute_dtype="bfloat16", batch_size=batch,
        lambda_depth=0.1, depth_loss_type="mse", interlevel_loss_mult=0.0,
        distortion_loss_mult=0.0, opacity_loss_mult=1e-3, lr_delay_steps=0,
    )


def nerfpp_bench_config(batch: int, model_overrides=None, config_overrides=None) -> Config:
    """The NeRF++ bench config with `model_overrides` on its model's params
    and `config_overrides` on the config's own fields."""
    kwargs = dict(
        model="nerfpp", model_params=dict(NERFPP_MODEL, **(model_overrides or {})),
        compute_dtype="bfloat16", batch_size=batch, lambda_depth=0.1, depth_loss_type="mse",
        depth_loss_reduce="mean_valid", interlevel_loss_mult=0.0, distortion_loss_mult=0.0,
        data_coarse_loss_mult=1.0, lr_delay_steps=0,
    )
    kwargs.update(config_overrides or {})
    return Config(**kwargs)


def bench_scene(batch: int, device, n_batches: int = 4):
    """(the synthetic scene, `n_batches` of its train batches on `device`)."""
    dataset = datasets_lib.SyntheticDataset("train", global_batch_size=batch, n_images=N_IMAGES,
                                            height=HEIGHT, width=WIDTH, seed=SCENE_SEED)
    return dataset, [rays_lib.to_device(dataset.sample_batch(), device)
                     for _ in range(n_batches)]


@dataclasses.dataclass
class BenchTrainer:
    """The probes' train loop on fixed batches; `step()` trains one step on
    the next batch in turn and returns its stats (not synchronized)."""

    config: Config
    device: torch.device
    model: torch.nn.Module
    train_step: object
    generator: torch.Generator
    batches: list
    calls: int = 0

    def step(self, train_frac: float = 0.5):
        i = self.calls
        self.calls += 1
        return self.train_step(self.batches[i % len(self.batches)], i, train_frac,
                               self.generator)

    def refresh(self, warmup: bool):
        """An NGP occupancy refresh (every cell, or a sample of them)."""
        update = step_lib.make_occupancy_update_fn(self.config, self.model)
        self.model.occupancy.copy_(update(self.model.occupancy, self.generator, warmup))


def bench_trainer(config: Config, device, n_batches: int = 4, seed: int = 0) -> BenchTrainer:
    """The config's model initialized from `seed` on `device`, its train step
    on `bench_scene`'s batches, and a generator seeded `seed + 1`."""
    dataset, batches = bench_scene(config.batch_size, device, n_batches)
    model = step_lib.build_model(config, generator=torch.Generator().manual_seed(seed)).to(device)
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    train_step = step_lib.make_train_step(config, model, optimizer, lr_fn,
                                          cameras=dataset.cameras_on(device),
                                          camtype=dataset.camtype)
    return BenchTrainer(config, torch.device(device), model, train_step,
                        torch.Generator(device=device).manual_seed(seed + 1), batches)
