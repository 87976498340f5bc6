"""`utils/raw.py` and the last camera helpers of the port against the
reference package on the CPU.

The raw utilities run on the inputs of the reference's own raw tests: Bayer
masks, demosaicing, exposure values and metadata, the DNG/TIFF reader on
the files `tests/test_raw_and_visibility.py` writes (its metadata TIFF,
strip and tile mosaics, a GRBG mosaic, a compressed file that must be
refused), `assemble_raw_dataset` with its post-processing closure, and the
affine colour matches. numpy code of both packages is held exactly (or to
float64 roundoff); `postprocess_raw` computes in float32 in both (the
reference through jnp), at 1e-6. The camera helpers: the pose and epipolar
helpers in float64 at 1e-10, `rays_to_ndc` in float32 at 1e-6 of the
largest coordinate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_raw_and_visibility as j_raw_tests
from outdoor_nerf_depth_torch.data import cameras as t_cameras
from outdoor_nerf_depth_torch.utils import raw as t_raw
from outdoor_nerf_depth_tpu.data import cameras as j_cameras
from outdoor_nerf_depth_tpu.utils import raw as j_raw

torch.set_num_threads(1)


def _metas():
    base = {"AsShotNeutral": [0.6, 1.0, 0.7],
            "ColorMatrix2": [0.9, 0.1, 0.0, 0.05, 0.8, 0.15, 0.0, 0.2, 0.8],
            "BlackLevel": 64, "WhiteLevel": 1023, "ISOSpeedRatings": 200}
    return [dict(base, ExposureTime=1 / 30), dict(base, ExposureTime=1 / 120),
            dict(base, ShutterSpeed="1/30"), dict(base, ShutterSpeedValue=5.0),
            {"ExposureTime": 0.01}]


def test_bayer_mask_and_demosaic_match():
    px, py = np.meshgrid(np.arange(9), np.arange(7), indexing="xy")
    np.testing.assert_array_equal(t_raw.pixels_to_bayer_mask(px, py),
                                  j_raw.pixels_to_bayer_mask(px, py))
    bayer = np.random.default_rng(0).uniform(size=(10, 14)).astype(np.float32)
    np.testing.assert_array_equal(t_raw.bilinear_demosaic(bayer), j_raw.bilinear_demosaic(bayer))


def test_exposure_and_metadata_match():
    metas = _metas()
    np.testing.assert_array_equal(t_raw.exposure_values(metas[:2]),
                                  j_raw.exposure_values(metas[:2]))
    for m in metas:
        assert t_raw._shutter_seconds(m) == j_raw._shutter_seconds(m)
    with pytest.raises(KeyError):
        t_raw._shutter_seconds({})
    got, want = t_raw.process_metadata(metas), j_raw.process_metadata(metas)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    imgs = np.random.default_rng(1).uniform(0, 4, (2, 6, 6, 3))
    for p in (97.0, 100.0):
        (a, la), (b, lb) = t_raw.normalize_exposure(imgs, p), j_raw.normalize_exposure(imgs, p)
        np.testing.assert_array_equal(a, b)
        assert la == lb


@pytest.mark.parametrize("n_downsample", [1, 2])
def test_assemble_raw_dataset_matches(n_downsample):
    rng = np.random.default_rng(3)
    raws = rng.uniform(64, 1023, size=(3, 8, 12)).astype(np.float32)
    metas = _metas()[:3]
    got, got_meta = t_raw.assemble_raw_dataset(raws, metas, n_downsample=n_downsample)
    want, want_meta = j_raw.assemble_raw_dataset(raws, metas, n_downsample=n_downsample)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert set(got_meta) == set(want_meta)
    for k in ("exposure_idx", "unique_shutters", "exposure_values", "cam2rgb", "exposure"):
        np.testing.assert_array_equal(got_meta[k], want_meta[k], err_msg=k)
    assert got_meta["exposure_levels"] == want_meta["exposure_levels"]
    np.testing.assert_allclose(got_meta["postprocess_fn"](got[0]),
                               np.asarray(want_meta["postprocess_fn"](want[0])), atol=1e-6)


def test_postprocess_raw_matches():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1.5, (5, 7, 3)).astype(np.float32)
    m = rng.normal(size=(3, 3)) * 0.2 + np.eye(3)
    for kwargs in ({}, {"exposure": 0.8}, {"cam2rgb": m}, {"cam2rgb": m, "exposure": 1.3}):
        got = t_raw.postprocess_raw(x, **kwargs)
        want = np.asarray(j_raw.postprocess_raw(jnp.asarray(x), **kwargs))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str(kwargs))
    with pytest.raises(ValueError, match="expected 3"):
        t_raw.postprocess_raw(x[..., :2])
    with pytest.raises(ValueError, match="expected \\(3, 3\\)"):
        t_raw.postprocess_raw(x, cam2rgb=np.eye(4))


def test_affine_color_matches():
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(8, 8, 3))
    ref = img @ rng.normal(size=(3, 3)).T + 0.1
    np.testing.assert_allclose(t_raw.match_affine_color(img, ref),
                               j_raw.match_affine_color(img, ref), atol=1e-12)
    est = img * np.array([1.5, 0.7, 2.0]) + np.array([0.1, -0.05, 0.2]) + 0.01 * rng.normal(
        size=img.shape)
    for axis in ((0, 1), 0):
        for got, want in zip(t_raw.best_fit_affine(img, est, axis),
                             j_raw.best_fit_affine(img, est, axis)):
            np.testing.assert_allclose(got, want, rtol=1e-12)
        np.testing.assert_allclose(t_raw.match_images_affine(est, img, axis),
                                   j_raw.match_images_affine(est, img, axis), rtol=1e-12)


def test_dng_metadata_matches(tmp_path):
    path = str(tmp_path / "frame.dng")
    j_raw_tests.TestDngMetadata()._write_tiff(path)
    assert t_raw.read_dng_metadata(path) == j_raw.read_dng_metadata(path)
    bad = tmp_path / "x.dng"
    bad.write_bytes(b"not a tiff")
    with pytest.raises(ValueError):
        t_raw.read_dng_metadata(str(bad))


@pytest.mark.parametrize("layout", [dict(tiled=False), dict(tiled=True),
                                    dict(tiled=False, cfa=(1, 0, 2, 1)),
                                    dict(tiled=True, cfa=(2, 1, 1, 0))])
def test_read_dng_matches(tmp_path, layout):
    mosaic = np.random.default_rng(6).integers(0, 2**14, (20, 28)).astype(np.uint16)
    path = str(tmp_path / "raw.dng")
    j_raw_tests._write_dng(path, mosaic, **layout)
    got, got_meta = t_raw.read_dng(path)
    want, want_meta = j_raw.read_dng(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert got_meta == want_meta


def test_load_raw_dataset_from_dngs_and_compressed_refused(tmp_path, monkeypatch):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"f{i}.dng")
        j_raw_tests._write_dng(p, np.random.default_rng(i).integers(0, 2**14, (8, 12)))
        paths.append(p)
    # The synthetic files carry no exposure tags: give both readers the same.
    meta = dict(ExposureTime=1 / 60, ISOSpeedRatings=800, BlackLevel=0.0, WhiteLevel=2**14)
    monkeypatch.setattr(t_raw, "read_dng_metadata", lambda p: dict(meta))
    monkeypatch.setattr(j_raw, "read_dng_metadata", lambda p: dict(meta))
    got, got_meta = t_raw.load_raw_dataset_from_dngs(paths)
    want, want_meta = j_raw.load_raw_dataset_from_dngs(paths)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_meta["exposure_values"], want_meta["exposure_values"])
    p = str(tmp_path / "ljpeg.dng")
    j_raw_tests._write_dng(p, np.zeros((8, 8), np.uint16), compression=7)
    with pytest.raises(ValueError, match="compression 7"):
        t_raw.read_dng(p)


# -- data/cameras.py ------------------------------------------------------------


def _poses(n=7, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses.append(np.concatenate([q, rng.normal(size=(3, 1)) * 3], axis=1))
    return np.stack(poses)


@pytest.mark.parametrize("with_points", [False, True])
def test_normalize_poses_min_norm_matches(with_points):
    poses = _poses()
    points = np.random.default_rng(1).normal(size=(50, 3)) if with_points else None
    got, got_scale = t_cameras.normalize_poses_min_norm(poses, points)
    want, want_scale = j_cameras.normalize_poses_min_norm(poses, points)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_scale, want_scale, rtol=1e-10)
    assert abs(np.linalg.norm(got[:, :3, 3], axis=-1).min() - 1.0) < 1e-10


def test_fundamental_matrix_and_epipolar_line_match():
    rng = np.random.default_rng(2)
    K1 = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]])
    K2 = np.array([[480.0, 0, 300], [0, 470, 250], [0, 0, 1]])
    w2c = [np.eye(4) for _ in range(2)]
    for m in w2c:
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, 3] = rng.normal(size=3)
    got = t_cameras.fundamental_matrix(K1, w2c[0], K2, w2c[1])
    want = j_cameras.fundamental_matrix(K1, w2c[0], K2, w2c[1])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    for px in ((10.0, 20.0), (320.5, 240.25)):
        np.testing.assert_allclose(t_cameras.epipolar_line(px, got),
                                   j_cameras.epipolar_line(px, want), rtol=1e-10, atol=1e-12)
    # A world point's two projections satisfy x2^T F x1 = 0.
    X = np.array([0.3, -0.2, 4.0, 1.0])
    x1, x2 = (K @ (m @ X)[:3] for K, m in ((K1, w2c[0]), (K2, w2c[1])))
    assert abs(x2 @ got @ x1) < 1e-8 * np.linalg.norm(x1) * np.linalg.norm(x2) * np.abs(got).max()


def test_rays_to_ndc_matches():
    rng = np.random.default_rng(3)
    origins = rng.normal(size=(64, 3)).astype(np.float32) * 0.1
    directions = np.concatenate([rng.normal(size=(64, 2)) * 0.3, -np.ones((64, 1))],
                                axis=-1).astype(np.float32)
    pixtocam = np.linalg.inv(np.array([[400.0, 0, 160], [0, 400, 120], [0, 0, 1]]))
    got = t_cameras.rays_to_ndc(torch.from_numpy(origins), torch.from_numpy(directions),
                                pixtocam, near=0.5)
    want = j_cameras.rays_to_ndc(jnp.asarray(origins), jnp.asarray(directions), pixtocam,
                                 near=0.5, xnp=jnp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6 * np.abs(w).max())
    got64 = t_cameras.rays_to_ndc(torch.from_numpy(origins.astype(np.float64)),
                                  torch.from_numpy(directions.astype(np.float64)), pixtocam)
    want64 = j_cameras.rays_to_ndc(origins.astype(np.float64), directions.astype(np.float64),
                                   pixtocam)
    for g, w in zip(got64, want64):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
