"""The port's data layer, losses and metrics against the reference package on
the same numpy inputs, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.data import rays as t_rays
from outdoor_nerf_depth_torch.train import losses as t_losses
from outdoor_nerf_depth_torch.train import metrics as t_metrics
from outdoor_nerf_depth_tpu.data import cameras as j_cameras
from outdoor_nerf_depth_tpu.data import datasets as j_datasets
from outdoor_nerf_depth_tpu.data import rays as j_rays
from outdoor_nerf_depth_tpu.train import losses as j_losses
from outdoor_nerf_depth_tpu.train import metrics as j_metrics

# The suite runs files in parallel worker processes: one torch thread per
# worker keeps these small CPU tests from crowding the timing-sensitive
# tests of other workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, atol=1e-6, rtol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


# -- data --------------------------------------------------------------------


def test_synthetic_batches_follow_the_reference_rng_streams():
    j_ds = j_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    t_ds = t_datasets.SyntheticDataset("train", global_batch_size=64, seed=1)
    np.testing.assert_array_equal(t_ds.images, j_ds.images)
    for _ in range(2):
        jb, tb = j_ds.sample_batch(), t_ds.sample_batch()
        assert isinstance(tb.rays, t_rays.Pixels)
        for name, val in _fields(jb.rays).items():
            np.testing.assert_array_equal(getattr(tb.rays, name).numpy(), val, err_msg=name)
        for name in ("rgb", "depth_gt", "depth_sup"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(), getattr(jb, name), err_msg=name)


def test_image_batch_rays_match_host_cast():
    # The reference casts eval rays in float64 numpy; the port in float32.
    jb = j_datasets.SyntheticDataset("test", seed=2).image_batch(1)
    tb = t_datasets.SyntheticDataset("test", seed=2).image_batch(1)
    for name, val in _fields(jb.rays).items():
        _close(getattr(tb.rays, name), val, atol=1e-6, rtol=1e-6)
    assert tb.rays.origins.shape == (8, 12, 3)


def test_cast_pixels_matches_device_cast():
    ds = j_datasets.SyntheticDataset("train", global_batch_size=32, seed=3)
    pixels = ds.sample_batch().rays
    cams_j = tuple(None if c is None else jnp.asarray(c) for c in ds.cameras)
    want = j_cameras.cast_pixels(pixels, cams_j, xnp=jnp)
    t_pixels = t_rays.Pixels(**{k: torch.from_numpy(np.asarray(v)) for k, v in _fields(pixels).items()})
    cams_t = tuple(None if c is None else torch.from_numpy(c) for c in ds.cameras)
    got = t_cameras.cast_pixels(t_pixels, cams_t)
    for name, val in _fields(want).items():
        _close(getattr(got, name), val, atol=1e-6, rtol=1e-6)


def test_dummy_rays_and_pad_to_multiple():
    j, t = j_rays.dummy_rays((5,), xnp=np), t_rays.dummy_rays((5,))
    for name, val in _fields(j).items():
        _close(getattr(t, name), val)
    padded, pad = t_rays.pad_to_multiple(t, 4)
    want, want_pad = j_rays.pad_to_multiple(j, 4)
    assert pad == want_pad == 3
    for name, val in _fields(want).items():
        _close(getattr(padded, name), val)
    assert t_rays.pad_to_multiple(t, 5) == (t, 0)


# -- losses ------------------------------------------------------------------


def _rng(seed):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("kind", ["mse", "charb"])
def test_rgb_loss(kind):
    pred, target = _rng(0).rand(2, 16, 3).astype(np.float32)
    lossmult = _rng(1).rand(16, 1).astype(np.float32)
    got = t_losses.rgb_loss(torch.from_numpy(pred), torch.from_numpy(target),
                            torch.from_numpy(lossmult), kind=kind)
    want = j_losses.rgb_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(lossmult),
                             kind=kind)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("kind", ["mse", "l1"])
@pytest.mark.parametrize("reduce", ["mean_all", "mean_valid"])
def test_expected_depth_loss(kind, reduce):
    pred = _rng(2).uniform(0, 10, 32).astype(np.float32)
    sup = np.where(_rng(3).rand(32) < 0.6, _rng(4).uniform(1, 9, 32), -1.0).astype(np.float32)
    got = t_losses.expected_depth_loss(torch.from_numpy(pred), torch.from_numpy(sup), kind, reduce)
    _close(got, j_losses.expected_depth_loss(jnp.asarray(pred), jnp.asarray(sup), kind, reduce),
           rtol=1e-5)


def _history(seed, n=16, s=8):
    tdist = np.sort(_rng(seed).uniform(0.5, 10.0, (n, s + 1)), -1).astype(np.float32)
    sdist = np.sort(_rng(seed + 1).rand(n, s + 1), -1).astype(np.float32)
    w = _rng(seed + 2).rand(n, s).astype(np.float32)
    w /= w.sum(-1, keepdims=True) * 1.1
    return dict(tdist=tdist, sdist=sdist, weights=w.astype(np.float32))


def _as(h, xp):
    conv = torch.from_numpy if xp is torch else jnp.asarray
    return {k: conv(v) for k, v in h.items()}


def test_kl_depth_loss_from_history():
    h = _history(5)
    sup = np.where(_rng(8).rand(16) < 0.7, _rng(9).uniform(1, 9, 16), -1.0).astype(np.float32)
    dirs = _rng(10).randn(16, 3).astype(np.float32)
    got = t_losses.depth_loss_from_history(_as(h, torch), torch.from_numpy(sup), None,
                                           torch.from_numpy(dirs), sigma=0.5, kind="kl")
    want = j_losses.depth_loss_from_history(_as(h, jnp), jnp.asarray(sup), None,
                                            jnp.asarray(dirs), sigma=0.5, kind="kl")
    _close(got, want, rtol=1e-5)  # -log(w) summed over a window: relative 1e-5


def test_interlevel_and_distortion_losses():
    hist = [_history(11, s=12), _history(14, s=10), _history(17, s=8)]
    t_hist = [_as(h, torch) for h in hist]
    j_hist = [_as(h, jnp) for h in hist]
    _close(t_losses.interlevel_loss(t_hist), j_losses.interlevel_loss(j_hist), rtol=1e-5)
    _close(t_losses.distortion_loss(t_hist), j_losses.distortion_loss(j_hist), rtol=1e-5)


# -- metrics -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(20, 24, 3), (6, 9, 3)])
def test_psnr_and_ssim(shape):
    pred, target = _rng(20).rand(2, *shape).astype(np.float32)
    target = np.clip(pred + 0.1 * _rng(21).randn(*shape), 0, 1).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    _close(t_metrics.psnr(tp, tt), j_metrics.psnr(jnp.asarray(pred), jnp.asarray(target)),
           rtol=1e-6)
    # SSIM: separable 11-tap blurs of products, then a ratio: 1e-5.
    _close(t_metrics.ssim(tp, tt), j_metrics.ssim(jnp.asarray(pred), jnp.asarray(target)),
           atol=1e-5)


def test_depth_metrics_and_suite():
    gt = np.where(_rng(22).rand(8, 12) < 0.7, _rng(23).uniform(1, 120, (8, 12)), -1.0)
    gt = gt.astype(np.float32)
    pred = np.abs(gt + _rng(24).randn(8, 12) * 3).astype(np.float32)
    got = t_metrics.depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt), depth_scale=2.0)
    want = j_metrics.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), depth_scale=2.0)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-5, atol=1e-6)
    rgb_p, rgb_t = _rng(25).rand(2, 8, 12, 3).astype(np.float32)
    t_out = t_metrics.MetricSuite()(rgb_p, rgb_t, pred, gt, depth_scale=2.0)
    j_out = j_metrics.MetricSuite()(rgb_p, rgb_t, pred, gt, depth_scale=2.0)
    assert set(t_out) == set(j_out)
    for k in j_out:
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=1e-5, atol=1e-5, err_msg=k)
