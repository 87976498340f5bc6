"""The port's VGG16 LPIPS (`train/lpips.py`) against the reference package's
on the CPU, with one `random_weights` dict fed to both: the weights file
contract, the distances on even and odd sizes and with a batch axis, and
the loud failures (no file, missing keys, no exporter stamp). Random
weights measure no perceptual distance; these tests hold the machinery."""

import jax
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.train import lpips as t_lpips
from outdoor_nerf_depth_torch.train import metrics as t_metrics
from outdoor_nerf_depth_tpu.train import lpips as j_lpips
from outdoor_nerf_depth_tpu.train import metrics as j_metrics

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    return t_lpips.random_weights(np.random.default_rng(0))


@pytest.fixture(scope="module")
def unstamped(tmp_path_factory, weights):
    path = str(tmp_path_factory.mktemp("lpips") / "random.npz")
    t_lpips.save_weights(path, weights)
    return path


@pytest.fixture(scope="module")
def stamped(tmp_path_factory, weights):
    path = str(tmp_path_factory.mktemp("lpips") / "stamped.npz")
    t_lpips.save_weights(path, weights, provenance=t_lpips.EXPORT_PROVENANCE)
    return path


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    return x, np.clip(x + 0.1 * rng.normal(size=shape), -0.05, 1.05).astype(np.float32)


def _jax_distance(path, pred, target):
    with jax.default_matmul_precision("highest"):
        return j_lpips.make_lpips_fn(path, require_export_provenance=False)(pred, target)


def test_random_weights_are_the_reference_draws(weights):
    want = j_lpips.random_weights(np.random.default_rng(0))
    assert sorted(weights) == sorted(want)
    for k in want:
        assert weights[k].dtype == want[k].dtype and np.array_equal(weights[k], want[k]), k


def test_weights_file_is_the_reference_format(unstamped, stamped, weights):
    got = t_lpips.load_weights(unstamped, require_export_provenance=False)
    want = j_lpips.load_weights(unstamped, require_export_provenance=False)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # Each package reads the other's file.
    assert j_lpips.load_weights(stamped).keys() == t_lpips.load_weights(stamped).keys()
    oihw = t_lpips.to_torch(got)["conv2_1/kernel"]
    assert tuple(oihw.shape) == (128, 64, 3, 3)
    assert np.array_equal(oihw.numpy(), weights["conv2_1/kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("shape", [(32, 48, 3), (33, 47, 3), (2, 32, 48, 3)],
                         ids=["even", "odd", "batch"])
def test_distance_matches_reference(unstamped, shape):
    pred, target = _images(shape, seed=sum(shape))
    got = t_lpips.make_lpips_fn(unstamped, require_export_provenance=False, device="cpu")(
        pred, target)
    want = _jax_distance(unstamped, pred, target)
    assert want > 0
    assert got == pytest.approx(want, rel=RTOL)


def test_pools_drop_the_odd_row_as_valid_windows(weights):
    """376 -> 188 -> 94 -> 47 -> 23 at KITTI's height, here on 45 x 37."""
    x = torch.zeros(1, 3, 45, 37)
    taps = t_lpips._vgg_features(t_lpips.to_torch(weights), x)
    sizes = [tuple(taps[n].shape[-2:]) for n in t_lpips.LPIPS_TAPS]
    assert sizes == [(45, 37), (22, 18), (11, 9), (5, 4), (2, 2)]


def test_identity_and_symmetry(unstamped):
    fn = t_lpips.make_lpips_fn(unstamped, require_export_provenance=False, device="cpu")
    x, y = _images((32, 48, 3), seed=5)
    assert fn(x, x) == pytest.approx(0.0, abs=1e-6)
    assert fn(y, x) == pytest.approx(fn(x, y), rel=1e-4)


def test_metric_suite_reports_lpips_like_the_reference(stamped):
    pred, target = _images((32, 48, 3), seed=9)
    got = t_metrics.MetricSuite(compute_lpips=True, lpips_weights=stamped, device="cpu")(
        pred, target)
    with jax.default_matmul_precision("highest"):
        want = j_metrics.MetricSuite(compute_lpips=True, lpips_weights=stamped)(pred, target)
    assert sorted(got) == sorted(want) == ["lpips", "psnr", "ssim"]
    assert got["lpips"] == pytest.approx(want["lpips"], rel=RTOL)


def test_missing_file_raises_loudly(tmp_path, monkeypatch):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(ValueError, match="not found"):
        t_lpips.load_weights(missing)
    with pytest.raises(ValueError, match="not found"):
        t_metrics.MetricSuite(compute_lpips=True, lpips_weights=missing, device="cpu")
    # The default path goes through ONDT_LPIPS_WEIGHTS, then the repo's weights/.
    monkeypatch.setenv("ONDT_LPIPS_WEIGHTS", missing)
    assert t_lpips.default_weights_path() == missing
    with pytest.raises(ValueError, match="not found"):
        t_metrics.MetricSuite(compute_lpips=True, device="cpu")
    monkeypatch.delenv("ONDT_LPIPS_WEIGHTS")
    assert t_lpips.default_weights_path().endswith("weights/lpips_vgg.npz")


def test_missing_keys_raise(tmp_path, weights):
    path = str(tmp_path / "partial.npz")
    partial = {k: v for k, v in weights.items() if k not in ("conv3_2/bias", "lin4/weight")}
    t_lpips.save_weights(path, partial, provenance=t_lpips.EXPORT_PROVENANCE)
    with pytest.raises(ValueError, match="missing keys.*conv3_2/bias.*lin4/weight"):
        t_lpips.load_weights(path)


def test_unstamped_weights_are_refused_on_metric_paths(unstamped, stamped):
    with pytest.raises(ValueError, match="provenance"):
        t_lpips.load_weights(unstamped)
    with pytest.raises(ValueError, match="provenance"):
        t_lpips.make_lpips_fn(unstamped, device="cpu")
    with pytest.raises(ValueError, match="provenance"):
        t_metrics.MetricSuite(compute_lpips=True, lpips_weights=unstamped, device="cpu")
    assert t_metrics.MetricSuite(compute_lpips=True, lpips_weights=stamped, device="cpu")


def test_lpips_defaults_to_cuda(stamped):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_lpips.make_lpips_fn(stamped)


def test_psnr_to_mse_inverts_mse_to_psnr():
    mse = torch.tensor([1e-4, 0.01, 0.5])
    assert torch.allclose(t_metrics.psnr_to_mse(t_metrics.mse_to_psnr(mse)), mse, rtol=1e-6)
    assert np.allclose(t_metrics.psnr_to_mse(30.0).numpy(),
                       np.asarray(j_metrics.psnr_to_mse(30.0)), rtol=1e-6)
