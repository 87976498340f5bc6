"""The port's OpenCV-free pose branch (`depth_priors/pose.py`) against the
reference package's, on the CPU.

Ported exactly, and held exactly: the luma, the 4x4 dilation (against
`cv2.dilate`, which the reference calls) and the Rodrigues formulas (to
1e-6 of `cv2.Rodrigues`, both directions). The ORB-style matcher and the
PnP are the port's own, held to the reference's contract: PnP-RANSAC on
drawn correspondences with 30% outliers lands within 1e-3 rad and 1e-3 |t|
of `cv2.solvePnPRansac` called with the reference's arguments; on the
reference test's blob pair the matcher keeps at least 100 matches, at
least 85% of them at the true shift; and `estimate_pose_pnp` recovers the
blob pair's and a textured plane's known poses within the reference
test's tolerances (R 0.05, t 0.15), as close to the reference's own
estimate. The warp runs in torch: `bilinear_sample` and `multiscale` at
1e-6 against the jnp versions, `inverse_warp` at 1e-6 plus the float32 rounding
of its reprojected coordinates (two ulps) times the image gradient,
and the photometric loss's gradient with respect to the depth at relative
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.depth_priors import completion as t_completion
from outdoor_nerf_depth_torch.depth_priors import pose as t_pose
from outdoor_nerf_depth_tpu.depth_priors import completion as j_completion
from outdoor_nerf_depth_tpu.depth_priors import pose as j_pose

cv2 = pytest.importorskip("cv2")

POSE_R_ATOL, POSE_T_ATOL = 0.05, 0.15  # the reference's test_estimate_pose_pnp_translation
WARP_ATOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def blob_pair(shift=6):
    """The reference test's pair: 8x8 colour blocks with noise, the near
    view rolled `shift` px right, at a constant depth of 10 (fx 100)."""
    rng = np.random.default_rng(33)
    h, w = 128, 192
    base = rng.uniform(size=(h // 8, w // 8, 3))
    rgb = np.kron(base, np.ones((8, 8, 1)))[:h, :w].astype(np.float32)
    rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
    rgb = np.clip(rgb, 0, 1)
    K = np.array([[100.0, 0, (w - 1) / 2], [0, 100.0, (h - 1) / 2], [0, 0, 1]], np.float32)
    return rgb, np.roll(rgb, shift, axis=1), np.full((h, w), 10.0, np.float32), K


def render_plane(tex, K, R, t, h, w, normal, offset, cell=0.25):
    """A textured plane {X : normal . X = offset} (world = first camera)
    seen by the camera X_cam = R X + t: the image (texture cells of `cell`
    along two in-plane axes) and the z-depth."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1)
    centre, dirs = -R.T @ t, rays @ R
    X = centre + ((offset - normal @ centre) / (dirs @ normal))[..., None] * dirs
    a = np.cross(normal, [0.0, 1.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(normal, a)
    ia = np.floor(X @ a / cell).astype(int) % tex.shape[1]
    ib = np.floor(X @ b / cell).astype(int) % tex.shape[0]
    return tex[ib, ia].astype(np.float32), (X @ R.T + t)[..., 2].astype(np.float32)


def plane_pair():
    rng = np.random.default_rng(40)
    h, w = 160, 240
    K = np.array([[200.0, 0, (w - 1) / 2], [0, 200.0, (h - 1) / 2], [0, 0, 1]])
    tex = rng.uniform(size=(64, 64, 3))
    normal = np.array([0.2, -0.1, 1.0]) / np.linalg.norm([0.2, -0.1, 1.0])
    R = t_pose.rodrigues(np.array([0.01, -0.03, 0.02]))
    t = np.array([0.4, -0.1, 0.3])
    img1, depth = render_plane(tex, K, np.eye(3), np.zeros(3), h, w, normal, 8.0)
    img2, _ = render_plane(tex, K, R, t, h, w, normal, 8.0)
    noisy = [np.clip(i + rng.normal(0, 0.01, i.shape), 0, 1).astype(np.float32)
             for i in (img1, img2)]
    return noisy[0], noisy[1], depth, K.astype(np.float32), R, t


# --------------------------------------------------------------------------
# Ported exactly.


def test_rgb_to_gray_matches_exactly():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_pose.rgb_to_gray_u8(rgb), j_pose.rgb_to_gray_u8(rgb))
    u8 = rng.integers(0, 256, (7, 9, 4)).astype(np.uint8)
    np.testing.assert_array_equal(t_pose.rgb_to_gray_u8(u8), j_pose.rgb_to_gray_u8(u8))


@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (4, 5)])
def test_dilation_matches_cv2_dilate(shape):
    rng = np.random.default_rng(1)
    depth = np.where(rng.uniform(size=shape) < 0.1, rng.uniform(1, 80, shape), 0.0)
    depth = depth.astype(np.float32)
    want = cv2.dilate(depth, np.ones((4, 4), np.uint8))
    np.testing.assert_array_equal(t_pose.dilate_depth(depth), want)
    # The anchor: one point at (3, 3) spreads to rows and columns 2-5.
    one = np.zeros((8, 8), np.float32)
    one[3, 3] = 1.0
    rows, cols = np.nonzero(t_pose.dilate_depth(one))
    assert (rows.min(), rows.max(), cols.min(), cols.max()) == (2, 5, 2, 5)


def test_rodrigues_matches_cv2_both_ways():
    rng = np.random.default_rng(2)
    vecs = [rng.normal(size=3) * s for s in (1e-9, 1e-3, 0.3, 1.0, 2.5, 3.1)]
    vecs += [np.zeros(3), np.array([np.pi - 1e-7, 0, 0]), np.array([0, 0, np.pi])]
    for r in vecs:
        want_R, _ = cv2.Rodrigues(r)
        np.testing.assert_allclose(t_pose.rodrigues(r), want_R, atol=1e-6, rtol=0)
        want_r, _ = cv2.Rodrigues(want_R)
        got_r = t_pose.rodrigues_vector(want_R)
        # Near pi, r and -r are the same rotation.
        if np.linalg.norm(r) > np.pi - 1e-3 and got_r @ want_r.ravel() < 0:
            got_r = -got_r
        np.testing.assert_allclose(got_r, want_r.ravel(), atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# PnP and matching, held to the reference's contract.


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_pnp_ransac_matches_cv2_with_outliers(seed):
    """200 points in a street-sized volume, 0.5 px noise, 30% of them moved
    at least 40 px: the RANSAC inliers are then the true ones, and both
    refine on them by least squares."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 256], [0, 500.0, 128], [0, 0, 1]])
    n = 200
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(5, 40, n)], -1)
    R = t_pose.rodrigues(rng.normal(size=3) * 0.05)
    t = rng.normal(size=3) * np.array([0.3, 0.1, 1.0])
    uv = t_pose._project(X, R, t, K) + rng.normal(0, 0.5, (n, 2))
    out = rng.permutation(n)[: int(0.3 * n)]
    angle = rng.uniform(0, 2 * np.pi, len(out))
    uv[out] += rng.uniform(40, 200, len(out))[:, None] * np.stack([np.cos(angle),
                                                                   np.sin(angle)], -1)
    X32, uv32 = X.astype(np.float32), uv.astype(np.float32)
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(X32[:, None], uv32[:, None], K, None)
    assert ok
    got_r, got_t, mask = t_pose.solve_pnp_ransac(X32, uv32, K)
    truth = np.ones(n, bool)
    truth[out] = False
    np.testing.assert_array_equal(mask, truth)
    # OpenCV's mask comes from its best 5-point model, which may leave out
    # a true inlier or two (seed 7: one). Its pose is then the least squares
    # on that set, which the port's refinement is held to.
    inliers = inliers.ravel()
    assert len(inliers) >= 0.98 * truth.sum() and truth[inliers].all()
    if len(inliers) < truth.sum():
        got_r, got_t = t_pose.refine_pose_lm(X32[inliers], uv32[inliers], K, got_r, got_t)
    dR = t_pose.rodrigues(got_r) @ cv2.Rodrigues(rvec)[0].T
    assert np.linalg.norm(t_pose.rodrigues_vector(dR)) < 1e-3
    assert np.linalg.norm(got_t - tvec.ravel()) < 1e-3 * np.linalg.norm(tvec)


def test_pnp_needs_four_points_and_fails_cleanly():
    K = np.eye(3)
    assert t_pose.solve_pnp_ransac(np.ones((3, 3)), np.ones((3, 2)), K) is None
    rgb = np.zeros((64, 64, 3), np.float32)  # no texture: no keypoints
    assert t_pose.estimate_pose_pnp(rgb, rgb, np.ones((64, 64), np.float32), K) == (
        False, None, None)


def test_match_features_on_the_blob_pair():
    rgb, near, _, _ = blob_pair()
    p1, p2 = t_pose.match_features(t_pose.rgb_to_gray_u8(rgb), t_pose.rgb_to_gray_u8(near))
    assert p1.dtype == p2.dtype == np.int32 and p1.shape == p2.shape
    shift = p2 - p1
    at_shift = (shift[:, 0] == 6) & (shift[:, 1] == 0)
    assert len(p1) >= 100 and at_shift.mean() >= 0.85, (len(p1), at_shift.mean())


@pytest.mark.parametrize("scene", ["blob", "plane"])
def test_estimate_pose_recovers_the_known_pose(scene):
    if scene == "blob":
        rgb, near, depth, K = blob_pair()
        R_true, t_true = np.eye(3), np.array([6 * 10.0 / 100.0, 0.0, 0.0])
    else:
        rgb, near, depth, K, R_true, t_true = plane_pair()
    ok, R, t = t_pose.estimate_pose_pnp(rgb, near, depth, K)
    j_ok, j_R, j_t = j_pose.estimate_pose_pnp(rgb, near, depth, K)
    assert ok and j_ok
    assert R.dtype == t.dtype == np.float32 and R.shape == (3, 3) and t.shape == (3,)
    np.testing.assert_allclose(R, R_true, atol=POSE_R_ATOL)
    np.testing.assert_allclose(t, t_true, atol=POSE_T_ATOL)
    np.testing.assert_allclose(R, j_R, atol=POSE_R_ATOL)
    np.testing.assert_allclose(t, j_t, atol=POSE_T_ATOL)


def test_ransac_draws_from_its_own_generator():
    """Deterministic per seed, and no draw from numpy's global state."""
    rgb, near, depth, K = blob_pair()
    state = np.random.get_state()[1].copy()
    first = t_pose.estimate_pose_pnp(rgb, near, depth, K)
    second = t_pose.estimate_pose_pnp(rgb, near, depth, K)
    np.testing.assert_array_equal(np.random.get_state()[1], state)
    np.testing.assert_array_equal(first[1], second[1])
    np.testing.assert_array_equal(first[2], second[2])


# --------------------------------------------------------------------------
# The warp, in torch.


def test_bilinear_sample_matches():
    rng = np.random.default_rng(30)
    img = rng.uniform(size=(6, 8, 3)).astype(np.float32)
    x = rng.uniform(-2, 10, (5, 7)).astype(np.float32)
    y = rng.uniform(-2, 8, (5, 7)).astype(np.float32)
    want = np.asarray(j_pose.bilinear_sample(jnp.asarray(img), x, y))
    got = t_pose.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, rtol=0)
    batched = t_pose.bilinear_sample(torch.from_numpy(np.stack([img, img[::-1].copy()])),
                                     torch.from_numpy(np.stack([x, x])),
                                     torch.from_numpy(np.stack([y, y])))
    np.testing.assert_allclose(batched[0].numpy(), want, atol=WARP_ATOL, rtol=0)
    want1 = np.asarray(j_pose.bilinear_sample(jnp.asarray(img[::-1].copy()), x, y))
    np.testing.assert_allclose(batched[1].numpy(), want1, atol=WARP_ATOL, rtol=0)


def _warp_inputs(seed=31, n=2, h=16, w=20):
    rng = np.random.default_rng(seed)
    near = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    rgb = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    depth = rng.uniform(3.0, 9.0, (n, h, w)).astype(np.float32)
    depth[:, 0, :3] = 0.0  # no depth: invalid
    R = np.stack([t_pose.rodrigues(rng.normal(size=3) * 0.05) for _ in range(n)]).astype(
        np.float32)
    t = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    K = np.array([[30.0, 0, 9.5], [0, 30.0, 7.5], [0, 0, 1]], np.float32)
    return near, rgb, depth, R, t, K


@pytest.mark.parametrize("texture", ["smooth", "noise"])
def test_inverse_warp_matches_per_item_and_batched(texture):
    """Validity exactly; colours at 1e-6 plus what two float32 ulps of the
    reprojected coordinates move them. The coordinates (up to ~23 px, where
    an ulp is 1.9e-6 px) differ by an ulp with the summation order of the
    3x3 point product, as the reference's own jit and eager products
    differ; the colour then moves by that times the image's largest
    gradient: ~0.25 a pixel for a smooth frame, ~1 for pixel noise."""
    near, _, depth, R, t, K = _warp_inputs()
    if texture == "smooth":
        coarse = torch.from_numpy(near[:, ::4, ::4].copy()).permute(0, 3, 1, 2)
        near = torch.nn.functional.interpolate(coarse, size=near.shape[1:3], mode="bilinear",
                                               align_corners=False).permute(0, 2, 3, 1)
        near = np.ascontiguousarray(near.numpy())
    gradient = max(np.abs(np.diff(near, axis=a)).max() for a in (1, 2))
    atol = WARP_ATOL + np.spacing(np.float32(32.0)) * gradient
    got_w, got_v = t_pose.inverse_warp(*map(torch.from_numpy, (near, depth, R, t, K)))
    for i in range(len(near)):
        want_w, want_v = j_pose.inverse_warp(jnp.asarray(near[i]), jnp.asarray(depth[i]),
                                             R[i], t[i], K)
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(want_v))
        np.testing.assert_allclose(got_w[i].numpy(), np.asarray(want_w), atol=atol, rtol=0)
        one_w, one_v = t_pose.inverse_warp(*map(torch.from_numpy, (near[i], depth[i], R[i],
                                                                     t[i], K)))
        np.testing.assert_array_equal(one_v.numpy(), got_v[i].numpy())
        np.testing.assert_allclose(one_w.numpy(), got_w[i].numpy(), atol=atol, rtol=0)
    assert 0.2 < got_v.float().mean() < 1.0


def test_photometric_loss_and_depth_gradient_match():
    near, rgb, depth, R, t, K = _warp_inputs(seed=32)
    success = np.array([1.0, 0.0], np.float32)

    def j_loss(d):
        warped, valid = jax.vmap(j_pose.inverse_warp, in_axes=(0, 0, 0, 0, None))(
            near, d, R, t, K)
        valid = valid & (success[:, None, None] > 0)
        return j_completion.photometric_loss(warped, rgb, mask=valid)

    want_loss, want_grad = jax.value_and_grad(j_loss)(jnp.asarray(depth))
    d = torch.from_numpy(depth).requires_grad_(True)
    warped, valid = t_pose.inverse_warp(torch.from_numpy(near), d, torch.from_numpy(R),
                                        torch.from_numpy(t), torch.from_numpy(K))
    valid = valid & (torch.from_numpy(success)[:, None, None] > 0)
    loss = t_completion.photometric_loss(warped, torch.from_numpy(rgb), mask=valid)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=GRAD_RTOL)
    want_grad = np.asarray(want_grad)
    assert np.abs(want_grad).max() > 0 and np.all(want_grad[1] == 0)
    np.testing.assert_allclose(d.grad.numpy(), want_grad,
                               atol=GRAD_RTOL * np.abs(want_grad).max(), rtol=0)


@pytest.mark.parametrize("channels", [3, 0])
def test_multiscale_matches(channels):
    rng = np.random.default_rng(34)
    img = rng.uniform(size=(17, 26, channels) if channels else (17, 26)).astype(np.float32)
    got = t_pose.multiscale(torch.from_numpy(img), 4)
    want = j_pose.multiscale(jnp.asarray(img), 4)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=WARP_ATOL, rtol=0)
